"""Seeded synthetic workloads for the tests and ``chip_smoke.py``.

Test support, not a feature: a 16S-like reference database in families
(members a few percent apart), and reads cut from its sequences with
substitutions and small indels (either strand), mixed with random junk.
Everything comes from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

ALPHA = np.frombuffer(b"ACGT", np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")

# the flags of the verify recipe: reads report, other, SAM, tabular BLAST
# with CIGAR / coverage / strand, OTU map, de-novo reads, 2 alignments
VERIFY_FLAGS = ["-fastx", "-other", "-sam", "-blast", "1 cigar qcov qstrand",
                "-otu_map", "-de_novo_otu", "-num_alignments", "2"]


def revcomp(s: bytes) -> bytes:
    return s.translate(_RC)[::-1]


def _mutate(rng, s: np.ndarray, n_sub: int, n_indel: int = 0) -> np.ndarray:
    s = s.copy()
    if n_sub:
        pos = rng.choice(len(s), size=min(n_sub, len(s)), replace=False)
        s[pos] = rng.choice(ALPHA, size=len(pos))
    for _ in range(n_indel):
        at = int(rng.integers(1, len(s) - 2))
        k = int(rng.integers(1, 3))
        if rng.random() < 0.5:
            s = np.concatenate([s[:at], s[at + k:]])
        else:
            s = np.concatenate([s[:at], rng.choice(ALPHA, size=k), s[at:]])
    return s


def make_db(path: str, n_seqs: int, n_families: int = 40,
            len_range: Tuple[int, int] = (1300, 1600),
            divergence: float = 0.08, seed: int = 0,
            name: str = "fam") -> List[bytes]:
    """Write a FASTA of ``n_seqs`` sequences in ``n_families`` families;
    members carry ``divergence/2`` substitutions each against their
    family's base, so two members are about ``divergence`` apart."""
    rng = np.random.default_rng(seed)
    lo, hi = len_range
    bases = [rng.choice(ALPHA, size=hi + 200) for _ in range(n_families)]
    seqs = []
    with open(path, "w") as f:
        for i in range(n_seqs):
            fam = i % n_families
            ln = int(rng.integers(lo, hi + 1))
            off = int(rng.integers(0, 200))
            s = _mutate(rng, bases[fam][off:off + ln],
                        int(ln * divergence / 2))
            seqs.append(s.tobytes())
            f.write(f">{name}{fam}_{i} synthetic 16S-like member {i}\n")
            f.write(seqs[-1].decode() + "\n")
    return seqs


def _cut(rng, sources: Sequence[bytes], ln: int, max_sub: int = 3,
         indel_p: float = 0.15) -> bytes:
    src = sources[int(rng.integers(0, len(sources)))]
    off = int(rng.integers(0, max(1, len(src) - ln)))
    s = np.frombuffer(src[off:off + ln], np.uint8)
    n_indel = 1 if rng.random() < indel_p else 0
    return _mutate(rng, s, int(rng.integers(0, max_sub + 1)),
                   n_indel).tobytes()


def make_reads(path: str, sources: Sequence[bytes], n_reads: int,
               len_range: Tuple[int, int] = (100, 150),
               frac_db: float = 0.5, seed: int = 1) -> None:
    """Write ``n_reads`` FASTA reads: a ``frac_db`` share cut from
    ``sources`` (0-3 substitutions, an occasional 1-2 nt indel, either
    strand), the rest random."""
    rng = np.random.default_rng(seed)
    lo, hi = len_range
    with open(path, "w") as f:
        for i in range(n_reads):
            ln = int(rng.integers(lo, hi + 1))
            if rng.random() < frac_db:
                r = _cut(rng, sources, ln)
                if rng.random() < 0.5:
                    r = revcomp(r)
            else:
                r = rng.choice(ALPHA, size=ln).tobytes()
            f.write(f">r{i}\n{r.decode()}\n")


def make_paired_reads(path1: str, path2: str, sources: Sequence[bytes],
                      n_pairs: int, seed: int = 2) -> None:
    """Paired FR reads: mate 2 starts 60 nt after mate 1 on the same
    source and is reverse-complemented.  Every fifth pair drifts heavily
    (passes the E-value, fails %id / %cov: de-novo candidates); one pair
    in ten is junk."""
    rng = np.random.default_rng(seed)
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i in range(n_pairs):
            ln = int(rng.integers(70, 141))
            if i % 10 == 9:
                m1 = rng.choice(ALPHA, size=90).tobytes()
                m2 = rng.choice(ALPHA, size=90).tobytes()
            else:
                src = sources[int(rng.integers(0, len(sources)))]
                off = int(rng.integers(0, max(1, len(src) - ln - 160)))
                n_sub = ln // 6 if i % 5 == 4 else int(rng.integers(0, 4))
                a = np.frombuffer(src[off:off + ln], np.uint8)
                b = np.frombuffer(src[off + 60:off + 60 + ln], np.uint8)
                m1 = _mutate(rng, a, n_sub).tobytes()
                m2 = revcomp(_mutate(rng, b, n_sub).tobytes())
            f1.write(f">p{i}/1\n{m1.decode()}\n")
            f2.write(f">p{i}/2\n{m2.decode()}\n")


def make_long_reads(db_path: str, reads_path: str, lens: Sequence[int],
                    n_each: int, longest: int = 0, seed: int = 3) -> None:
    """Reads of mixed lengths against long references: ``n_each`` reads of
    each length in ``lens`` (cut from three random 12,000-nt references,
    about 0.5% substitutions, every other one reverse-complemented), one
    read of ``longest`` nt when given (cut from a reference of ``longest``
    + 2,000 nt made for it), and ``n_each`` random 200-nt reads."""
    rng = np.random.default_rng(seed)
    refs = [rng.choice(ALPHA, size=12000).tobytes() for _ in range(3)]
    if longest:
        refs.append(rng.choice(ALPHA, size=longest + 2000).tobytes())
    with open(db_path, "w") as f:
        for i, r in enumerate(refs):
            f.write(f">longref{i} synthetic {len(r)} nt\n{r.decode()}\n")

    def cut(src: bytes, ln: int) -> bytes:
        off = int(rng.integers(0, len(src) - ln))
        return _mutate(rng, np.frombuffer(src[off:off + ln], np.uint8),
                       ln // 200).tobytes()

    with open(reads_path, "w") as f:
        k = 0
        for ln in lens:
            for _ in range(n_each):
                r = cut(refs[k % 3], ln)
                f.write(f">m{k}_{ln}\n"
                        f"{(revcomp(r) if k % 2 else r).decode()}\n")
                k += 1
        if longest:
            f.write(f">m{k}_{longest}\n{cut(refs[3], longest).decode()}\n")
        for i in range(n_each):
            f.write(f">junk{i}\n"
                    f"{rng.choice(ALPHA, size=200).tobytes().decode()}\n")


# A child that runs the align task and hard-exits (no clean-up, no
# consolidated state save) right after the journal's Nth unit checkpoint:
# a faithful SIGKILL stand-in at the only boundary a kill can differ from
# (mid-unit kills lose that unit's record and simply redo it).
#     python -c CRASH_CHILD <repo> <N> <batch size> <cpu|cuda> <CLI args>
# exits 9 once the Nth unit is journaled.
CRASH_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from sortmerna_tpu_torch.cli import parse_args
from sortmerna_tpu_torch.engine import state
from sortmerna_tpu_torch.engine.run import run_all

crash_after = int(sys.argv[2])
orig = state.AlignJournal.append
calls = [0]

def crashing_append(self, *a, **k):
    orig(self, *a, **k)
    calls[0] += 1
    if calls[0] >= crash_after:
        os._exit(9)

state.AlignJournal.append = crashing_append
run_all(parse_args(sys.argv[5:]), batch_size=int(sys.argv[3]),
        device=sys.argv[4])
"""


def scan_tiles(rng, B: int, Lq: int, Lr: int):
    """Random SW tiles (chars 0..4) for the column scan: every other pair
    holds a noisy copy of its query prefix, masks are ragged, and the
    first four pairs take the extreme lengths (1 and the full width).
    Returns Q, row_valid, R, col_valid, qlen, rlen (numpy)."""
    Q = rng.integers(0, 5, (B, Lq)).astype(np.int32)
    R = rng.integers(0, 5, (B, Lr)).astype(np.int32)
    n = min(Lq, Lr) // 2
    for b in range(0, B, 2):       # every other pair holds a noisy copy
        at = int(rng.integers(0, Lr - n))
        seg = Q[b, :n].copy()
        flip = rng.random(n) < 0.05
        seg[flip] = rng.integers(0, 5, int(flip.sum()))
        R[b, at:at + n] = seg
    qlen = rng.integers(1, Lq + 1, B)
    rlen = rng.integers(1, Lr + 1, B)
    qlen[:4] = [1, Lq, 1, Lq][:B]
    rlen[:4] = [1, 1, Lr, Lr][:B]
    rv = np.arange(Lq)[None] < qlen[:, None]
    cv = np.arange(Lr)[None] < rlen[:, None]
    return Q, rv, R, cv, qlen, rlen


def fused_block(rng, B: int, lq: int, lr: int,
                edge_rows: bool = True) -> np.ndarray:
    """A packed SW wave block (the sw_fused input) like the align task's:
    reads of 100-150 nt, ref windows of read length + 0..40 nt (both
    capped at the tile), 60% true (mutated) matches, minimal 38, plus
    the edge rows q_len = 1, r_len = 1, an all-mismatch pair, minimal
    above the score, and low-entropy (tie-heavy) pairs."""
    Q = rng.integers(0, 4, (B, lq)).astype(np.uint8)
    R = rng.integers(0, 4, (B, lr)).astype(np.uint8)
    ql = rng.integers(100, 151, B).clip(max=lq)
    rl = (ql + rng.integers(0, 41, B)).clip(max=lr)
    minimal = np.full(B, 38, np.int32)
    for b in range(B):
        if rng.random() < 0.6:
            n = int(min(ql[b], rl[b]))
            at = int(rng.integers(0, rl[b] - n + 1))
            seg = Q[b, :n].copy()
            flip = rng.random(n) < 0.04
            seg[flip] = rng.integers(0, 4, int(flip.sum()))
            R[b, at:at + n] = seg
    if edge_rows and B > 20:
        ql[0], rl[0] = 1, lr                  # one-char read
        ql[1], rl[1] = lq, 1                  # one-char ref
        Q[2], R[2] = 0, 1                     # all mismatches: end_ref -1
        minimal[3] = 1 << 20                  # minimal above any score
        Q[4:12], R[4:12] = 0, 0               # ties everywhere
        Q[12:20, ::2], R[12:20, ::2] = 1, 1
        Q[20, :] = 4                          # N against N
    return pack_block(Q, R, ql, rl, minimal)


def pack_block(Q, R, ql, rl, minimal) -> np.ndarray:
    """Chars [B, lq] / [B, lr] (0..15) and the per-pair q_len, r_len,
    minimal as the packed sw_fused input; chars past each length are
    zeroed, as the align task packs them."""
    B, lq = Q.shape
    lr = R.shape[1]
    Q = np.where(np.arange(lq)[None] < ql[:, None], Q, 0).astype(np.uint8)
    R = np.where(np.arange(lr)[None] < rl[:, None], R, 0).astype(np.uint8)
    buf = np.empty((B, lq // 2 + lr // 2 + 12), np.uint8)
    buf[:, :lq // 2] = (Q[:, ::2] << 4) | Q[:, 1::2]
    buf[:, lq // 2:lq // 2 + lr // 2] = (R[:, ::2] << 4) | R[:, 1::2]
    ints = np.stack([np.asarray(v).astype(np.int32)
                     for v in (ql, rl, minimal)], 1)
    buf[:, lq // 2 + lr // 2:] = ints.astype("<i4").view(np.uint8)
    return buf


def long_block(rng, B: int, lq: int, lr: int) -> np.ndarray:
    """A packed wave block of long pairs, every one a true match: queries
    of 7/8 to all of lq, refs of 7/8 to all of lr holding the query from
    column 4 on with 0.5% substitutions (the long-tile timing input)."""
    ql = rng.integers(lq * 7 // 8, lq + 1, B)
    rl = rng.integers(lr * 7 // 8, lr + 1, B)
    Q = rng.integers(0, 4, (B, lq)).astype(np.int32)
    R = rng.integers(0, 4, (B, lr)).astype(np.int32)
    for b in range(B):
        n = int(min(ql[b], rl[b] - 4))
        seg = Q[b, :n].copy()
        flip = rng.random(n) < 0.005
        seg[flip] = rng.integers(0, 4, int(flip.sum()))
        R[b, 4:4 + n] = seg
    return pack_block(Q, R, ql, rl, np.full(B, 60, np.int32))


# Gap penalties (open, extend) of the edge inputs: the default, go < ge
# (where F from Hpre and F from H part ways), and zero (ties everywhere).
EDGE_GAPS = ((5, 2), (1, 3), (0, 0))

# The odd codes of the scan contract: chars outside 0..4, on both sides of
# it, where the JAX package's gathers wrap, clamp or fill.
ODD_CODES = (-7, 16)            # low, high (exclusive)


def _sprinkle(rng, a: np.ndarray, share: float, lo: int, hi: int) -> None:
    """A share of a's entries replaced, in place, by codes drawn from
    lo..hi-1."""
    hit = rng.random(a.shape) < share
    a[hit] = rng.integers(lo, hi, int(hit.sum()))


def odd_tiles(rng, B: int, Lq: int, Lr: int):
    """Scan-contract tiles (``scan_tiles``) with a fifth of the query and
    ref chars replaced by codes in -7..15.  Returns Q, row_valid, R,
    col_valid, qlen, rlen (numpy)."""
    Q, rv, R, cv, qlen, rlen = scan_tiles(rng, B, Lq, Lr)
    _sprinkle(rng, Q, 0.2, *ODD_CODES)
    _sprinkle(rng, R, 0.2, *ODD_CODES)
    return Q, rv, R, cv, qlen.astype(np.int32), rlen.astype(np.int32)


def _edge_chars(rng, B: int, Lq: int, Lr: int, top: int):
    """Q, R chars in 0..top-1 for the edge inputs: every other pair holds
    a noisy copy of its query's head in its ref; a quarter of the pairs
    is low-entropy (chars 0 and 1 only), one in sixteen constant and one
    in sixteen all-mismatch (a best of 0: no column may look better)."""
    Q = rng.integers(0, top, (B, Lq))
    R = rng.integers(0, top, (B, Lr))
    low = np.arange(B) % 4 == 3
    Q[low] %= 2
    R[low] %= 2
    const = np.arange(B) % 16 == 7
    Q[const] = 1
    R[const] = 1
    for b in range(0, B, 2):
        n = int(rng.integers(1, min(Lq, Lr) + 1))
        at = int(rng.integers(0, Lr - n + 1))
        seg = Q[b, :n].copy()
        flip = rng.random(n) < 0.05
        seg[flip] = rng.integers(0, top, int(flip.sum()))
        R[b, at:at + n] = seg
    miss = np.arange(B) % 16 == 13
    Q[miss] = 0
    R[miss] = 1
    return Q, R


def _edge_lengths(B: int, L: int) -> np.ndarray:
    """Lengths spread evenly from 1 to L over the block (pair b gets
    1 + b * L // B), so one launch of a warp-per-pair kernel meets every
    count of rows a lane from 1 up to ceil(L / 32)."""
    return 1 + np.arange(B) * L // B


def edge_tiles(rng, B: int, Lq: int, Lr: int, odd: bool = False):
    """Scan-contract tiles on which a wavefront kernel is likeliest to go
    wrong: query lengths spread from 1 to Lq (``_edge_lengths``), ref
    lengths from 1 to Lr in shuffled order, tie-heavy low-entropy pairs
    (``_edge_chars``), and in one pair of five holes in the row mask
    (invalid rows inside the span still feed the gap chain).  ``odd``:
    also 5% of the query and ref chars replaced by codes in -7..15 (v1's
    odd chars).  Returns Q, row_valid, R, col_valid (numpy)."""
    Q, R = _edge_chars(rng, B, Lq, Lr, 5)
    qlen = _edge_lengths(B, Lq)
    rlen = rng.permutation(_edge_lengths(B, Lr))
    rv = np.arange(Lq)[None] < qlen[:, None]
    cv = np.arange(Lr)[None] < rlen[:, None]
    holes = np.arange(B) % 5 == 4
    rv[holes] &= rng.random((int(holes.sum()), Lq)) < 0.85
    if odd:
        _sprinkle(rng, Q, 0.05, *ODD_CODES)
        _sprinkle(rng, R, 0.05, *ODD_CODES)
    return Q.astype(np.int32), rv, R.astype(np.int32), cv


def edge_tscore(rng, best) -> np.ndarray:
    """Terminate scores at or below the forward best (best - 0..5, at
    least 0), so a begin-pass-like scan may stop mid-scan at an earlier
    column whose maximum hits it."""
    best = np.asarray(best)
    return np.maximum(best - rng.integers(0, 6, best.shape), 0) \
        .astype(np.int32)


def edge_block(rng, B: int, lq: int, lr: int,
               odd: bool = False) -> np.ndarray:
    """A packed sw_fused block of edge inputs: read lengths spread from 1
    to lq (``_edge_lengths``), ref lengths read length + 0..40 (capped at
    the tile), chars 0..4 (N included), tie-heavy low-entropy pairs, and
    minimal 1..40 so most pairs run the begin pass.  ``odd``: also 5% of
    the chars replaced by nibbles 0..15."""
    Q, R = _edge_chars(rng, B, lq, lr, 5)
    ql = _edge_lengths(B, lq)
    rl = (ql + rng.integers(0, 41, B)).clip(max=lr)
    minimal = rng.integers(1, 41, B)
    if odd:
        _sprinkle(rng, Q, 0.05, 0, 16)
        _sprinkle(rng, R, 0.05, 0, 16)
    return pack_block(Q, R, ql, rl, minimal)


def _normal_log(text: str, paths: Sequence[str]) -> str:
    """aligned.log without the Command, pid and date lines, each of
    ``paths`` replaced by ``<dir>``."""
    keep = []
    skip_next = False
    for ln in text.splitlines(keepends=True):
        if skip_next:               # the command line under " Command:"
            skip_next = False
            continue
        if ln.startswith(" Command:"):
            skip_next = True
            continue
        if ln.startswith(" Process pid"):
            continue
        if ln.startswith(" ") and ln.strip()[:3] in (
                "Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"):
            continue
        for d in paths:
            ln = ln.replace(d, "<dir>")
        keep.append(ln)
    return "".join(keep)


def _normal_report(name: str, data: bytes, paths: Sequence[str]):
    """One report's bytes as the comparisons take them: SAM without its
    @PG line (it carries the command line), the log normalised."""
    if name.endswith(".sam"):
        return b"".join(ln for ln in data.splitlines(keepends=True)
                        if not ln.startswith(b"@PG"))
    if name.endswith(".log"):
        return _normal_log(data.decode(), paths)
    return data


def read_outputs(out_dir: str, paths: Sequence[str] = ()) -> dict:
    """The reports of one run, normalised for comparison across runs:
    aligned.sam without its @PG line (it carries the command line);
    aligned.log without the Command, pid and date lines and with each of
    ``paths`` (run-specific directories) replaced by ``<dir>``."""
    got = {}
    for name in ("aligned.blast", "aligned.fa", "other.fa", "otu_map.txt",
                 "aligned_denovo.fa", "aligned.sam", "aligned.log"):
        p = os.path.join(out_dir, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                got[name] = _normal_report(name, f.read(), paths)
    return got


def read_reports(out_dir: str, paths: Sequence[str] = ()) -> dict:
    """Every file of ``out_dir`` (fastq and gzip reports too), normalised
    as ``read_outputs`` does; a ``.gz`` file is read decompressed, under
    its name without ``.gz`` (a multi-member stream as one)."""
    import gzip
    got = {}
    for name in sorted(os.listdir(out_dir)):
        p = os.path.join(out_dir, name)
        if not os.path.isfile(p):
            continue
        with open(p, "rb") as f:
            data = f.read()
        if name.endswith(".gz"):
            name, data = name[:-3], gzip.decompress(data)
        got[name] = _normal_report(name, data, paths)
    return got


# ---------------------------------------------------------------------------
# the device seed probe: windows and edge inputs


def read_windows(reads: str, L: int, n: int, seed: int):
    """``n`` windows of L nt cut from the FASTA ``reads`` (starts every L/2
    nt), a quarter of them with 1-2 point edits, as int64 packed
    (L/2)-mer halves w1, w2."""
    pw = L // 2
    code = np.zeros(256, np.int64)
    code[list(b"ACGT")] = [0, 1, 2, 3]
    wins = []
    with open(reads, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                continue
            e = code[np.frombuffer(line.strip(), np.uint8)]
            wins += [e[st:st + L] for st in range(0, len(e) - L + 1, pw)]
            if len(wins) >= n:
                break
    w = np.stack(wins[:n])
    rng = np.random.default_rng(seed)
    for _ in range(2):
        rows = np.flatnonzero(rng.random(n) < 0.125)
        w[rows, rng.integers(0, L, len(rows))] = rng.integers(0, 4, len(rows))
    weights = 4 ** np.arange(pw - 1, -1, -1)
    return w[:, :pw] @ weights, w[:, pw:] @ weights


_EMPTY = -1                     # index/hashtab.EMPTY_KEY as int64
_FILLER = 1 << 62               # filler keys: above every probe key


class _EdgeTable:
    """An open-addressing table of index/hashtab.py's layout (int64 keys,
    EMPTY = -1; int32 value rows), written slot by slot."""

    def __init__(self, bits: int, width: int):
        from .index.hashtab import hash_u64
        self._hash = hash_u64
        self.bits, self.size = bits, 1 << bits
        self.keys = np.full(self.size, _EMPTY, np.int64)
        self.vals = np.zeros((self.size, width) if width else self.size,
                             np.int64)
        self._fill = 0

    def home(self, key: int) -> int:
        return int(self._hash(np.array([key], np.uint64), self.bits)[0])

    def filler(self) -> int:
        self._fill += 1
        return _FILLER + self._fill

    def free(self, key: int, span: int) -> bool:
        """Whether the ``span`` slots from key's home slot are all empty."""
        h = self.home(key)
        return all(self.keys[(h + i) % self.size] == _EMPTY
                   for i in range(span))

    def chain(self, key: int, val, pos: int) -> None:
        """``key`` at slot ``pos`` (1 = its home slot) of its chain, every
        slot before it filled; the chain wraps at the table's end."""
        h = self.home(key)
        for i in range(pos - 1):
            at = (h + i) % self.size
            if self.keys[at] == _EMPTY:
                self.keys[at] = self.filler()
        self.keys[(h + pos - 1) % self.size] = key
        self.vals[(h + pos - 1) % self.size] = val

    def insert(self, key: int, val) -> None:
        """Linear probing from the home slot (a key already there keeps
        its value)."""
        at = self.home(key)
        while self.keys[at] not in (_EMPTY, key):
            at = (at + 1) % self.size
        if self.keys[at] == _EMPTY:
            self.keys[at] = key
            self.vals[at] = val

    def fill_all(self) -> None:
        """Every empty slot filled: no chain meets EMPTY."""
        for at in np.flatnonzero(self.keys == _EMPTY):
            self.keys[at] = self.filler()


def _put_char(p: int, pw: int, i: int, c: int) -> int:
    shift = 2 * (pw - 1 - i)
    return (p & ~(3 << shift)) | (c << shift)


def _char(p: int, pw: int, i: int) -> int:
    return (p >> (2 * (pw - 1 - i))) & 3


def _del(p: int, pw: int, k: int) -> int:
    return ((p >> (2 * (pw - k))) << (2 * (pw - 1 - k))) \
        | (p & ((1 << (2 * (pw - 1 - k))) - 1))


def _ins9(p: int, pw: int, k: int, c: int) -> int:
    hi = p >> (2 * (pw - k))
    mid = (p >> 2) & ((1 << (2 * (pw - 1 - k))) - 1)
    return (((hi << 2) | c) << (2 * (pw - 1 - k))) | mid


def _rev(p: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out, p = (out << 2) | (p & 3), p >> 2
    return out


def probe_keys(a: int, b: int, pw: int) -> dict:
    """The keys window a.b probes, by kind (the closed forms of
    seed_search._probe_kernel): 'fx0' / 'rx0' the 0-error key, 'fsub' /
    'rsub' the 3pw substitutions that change a char (the other pw repeat
    the 0-error key), 'fdel' / 'rdel' the pw deletions, 'fins' / 'rins'
    the 4pw insertions (19-mers)."""
    s = 2 * pw
    key0 = (a << s) | b
    pr = _rev(a, pw)
    subs = [(i, c) for i in range(pw) for c in range(4)]
    return {
        "fx0": key0, "rx0": key0,
        "fsub": [(a << s) | _put_char(b, pw, i, c) for i, c in subs
                 if c != _char(b, pw, i)],
        "rsub": [(_put_char(a, pw, i, c) << s) | b for i, c in subs
                 if c != _char(a, pw, i)],
        "fdel": [(a << (s - 2)) | _del(b, pw, k) for k in range(pw)],
        "rdel": [(_del(a, pw, k) << s) | b for k in range(pw)],
        "fins": [(a << (s + 2)) | (_ins9(b, pw, k, c) << 2) | (b & 3)
                 for k in range(pw) for c in range(4)],
        "rins": [((a >> (s - 2)) << (2 * s))
                 | (_rev(_ins9(pr, pw, k, c), pw) << s) | b
                 for k in range(pw) for c in range(4)],
    }


def _distinct_window(rng, pw: int) -> Tuple[int, int]:
    """A window whose halves have no two equal neighbouring chars, so its
    deletion keys are distinct."""
    def half():
        c = [int(rng.integers(0, 4))]
        while len(c) < pw:
            c.append(int((c[-1] + rng.integers(1, 4)) % 4))
        return int(np.array(c) @ (4 ** np.arange(pw - 1, -1, -1)))
    return half(), half()


class _EdgeCase:
    """One probe edge input under construction: five tables, r_ids,
    kmer_counts, windows, and the (window, id) pairs the result must and
    must not hold."""

    def __init__(self, name: str, pw: int, bits: int, minoccur: int = 0):
        self.name, self.pw, self.minoccur = name, pw, minoccur
        from .ops.seed_search import VAL_WIDTH
        self.t = {k: _EdgeTable(bits, w) for k, w in VAL_WIDTH.items()}
        self.r_ids: List[int] = []
        self.counts = np.full(1 << (2 * pw), minoccur + 3, np.int64)
        self.w1: List[int] = []
        self.w2: List[int] = []
        self.present: List[Tuple[int, int]] = []
        self.absent: List[Tuple[int, int]] = []

    def window(self, a: int, b: int) -> int:
        self.w1.append(a)
        self.w2.append(b)
        return len(self.w1) - 1

    def group(self, ids: Sequence[int]) -> int:
        """Append ids to r_ids; returns their start."""
        self.r_ids += list(ids)
        return len(self.r_ids) - len(ids)

    def build(self) -> dict:
        tabs = {}
        for k, t in self.t.items():
            tabs[k + "_keys"] = t.keys.copy()
            # uint32 values wrap to int32, as the searchers store them
            tabs[k + "_val"] = t.vals.astype(np.uint32).view(np.int32)
        tabs["r_ids"] = np.asarray(self.r_ids or [0], np.int64) \
            .astype(np.uint32).view(np.int32)
        tabs["kmer_counts"] = self.counts.copy()
        return dict(name=self.name, tabs=tabs, pw=self.pw,
                    w1=np.asarray(self.w1, np.int64),
                    w2=np.asarray(self.w2, np.int64),
                    minoccur=self.minoccur, present=list(self.present),
                    absent=list(self.absent))


def _ids(rng, n: int) -> List[int]:
    """n distinct ids as uint32 values, a third of them >= 2**31 (they
    wrap negative as int32)."""
    lo = rng.choice(1 << 30, n - n // 3, replace=False)
    hi = (1 << 31) + rng.choice(1 << 30, n // 3, replace=False)
    return [int(x) for x in rng.permutation(np.concatenate([lo, hi]))]


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _chains_case(rng, pw: int) -> dict:
    """Chains of the probe tables: keys at slot 32 of a full chain (found)
    and at slot 33 (not found), a chain of 32 filled slots, chains that
    wrap from the last slot to slot 0, chains across sector boundaries."""
    e = _EdgeCase("chains", pw, bits=12)
    fx, rx, rp = e.t["fx"], e.t["rx"], e.t["rp"]

    def fresh(table, kind, span, want=None):
        # a window whose `kind` key has `span` empty slots from its home
        # (and, with `want`, a home slot inside it)
        while True:
            a, b = _distinct_window(rng, pw)
            keys = probe_keys(a, b, pw)
            key = keys[kind][0] if isinstance(keys[kind], list) \
                else keys[kind]
            h = table.home(key)
            if (want is None or h in want) and table.free(key, span) \
                    and fx.free(keys["fx0"], 1) and rx.free(keys["rx0"], 1):
                return a, b, key

    ids = _ids(rng, 64)
    # F-exact (0-error) keys at slot 32 and 33 of their chains
    for pos, must in ((32, True), (33, False), (31, True), (5, True)):
        a, b, key = fresh(fx, "fx0", 40)
        w = e.window(a, b)
        fx.chain(key, ids.pop(), pos)
        (e.present if must else e.absent).append((w, _i32(fx.vals[
            (fx.home(key) + pos - 1) % fx.size])))
    # an F substitution key at slot 32 and one at slot 33 (other mode)
    for pos, must in ((32, True), (33, False)):
        a, b, key = fresh(fx, "fsub", 40)
        w = e.window(a, b)
        fx.chain(key, ids.pop(), pos)
        (e.present if must else e.absent).append((w, _i32(fx.vals[
            (fx.home(key) + pos - 1) % fx.size])))
    # 32 filled slots, then EMPTY: the R-exact key is missing
    a, b, key = fresh(rx, "rx0", 40)
    e.window(a, b)
    h = rx.home(key)
    for i in range(32):
        rx.keys[(h + i) % rx.size] = rx.filler()
    # chains wrapping from the last slot to slot 0: an R-exact group (the
    # window's mode B) and an R-deletion group
    top = set(range(rx.size - 3, rx.size))
    for table, kind, cap in ((rx, "rx0", 4), (rp, "rdel", 16)):
        a, b, key = fresh(table, kind, 8, want=top)
        w = e.window(a, b)
        members = _ids(rng, cap)
        start = e.group(members)
        val = [start, cap, members[0]] if kind == "rx0" else [start, cap]
        table.chain(key, val, 5)
        e.present += [(w, _i32(m)) for m in members[:1]]
    # other-mode windows with their probes at chain slots 2..7 (sector
    # boundaries) in every table
    for _ in range(6):
        a, b = _distinct_window(rng, pw)
        w = e.window(a, b)
        keys = probe_keys(a, b, pw)
        for kind, table in (("fsub", fx), ("fdel", e.t["fp"]),
                            ("fins", e.t["k19"]), ("rsub", rx),
                            ("rdel", rp), ("rins", e.t["k19"])):
            key = keys[kind][int(rng.integers(0, len(keys[kind])))]
            if not table.free(key, 8):
                continue
            if kind in ("fsub", "fins", "rins"):
                val = ids.pop()
            elif kind == "fdel":
                val = [ids.pop() & 0x3FFFFFFF, 3]
            else:
                val = [e.group(_ids(rng, 4)), 4] + [0] * (kind == "rsub")
            table.chain(key, val, int(rng.integers(2, 8)))
    return e.build()


def _fill_window(e: _EdgeCase, rng, a: int, b: int, m: int) -> None:
    """Put window a.b's keys in the tables so its probes collect exactly m
    ids (before de-dup): R-deletion groups of 16, R-substitution groups of
    4, then single F-substitution ids.  Its 0-error keys stay out."""
    keys = probe_keys(a, b, pw=e.pw)
    left = m
    for key in keys["rdel"]:
        if left >= 16:
            e.t["rp"].insert(key, [e.group(_ids(rng, 16)), 16])
            left -= 16
    for key in keys["rsub"]:
        if left >= 4:
            e.t["rx"].insert(key, [e.group(_ids(rng, 4)), 4, 0])
            left -= 4
    for key in keys["fsub"][:left]:
        e.t["fx"].insert(key, _ids(rng, 3)[0])
    assert left <= len(keys["fsub"])


def _groups_case(rng, pw: int) -> dict:
    """Windows at the expansion caps and the sort's sizes, clamped r_ids
    starts, a shut gate, ids repeated across kinds, ids that wrap
    negative, an id equal to BIG, and modes A and B at once (minoccur 2)."""
    e = _EdgeCase("groups", pw, bits=14, minoccur=2)
    fx, fp, rx, rp, k19 = (e.t[k] for k in ("fx", "fp", "rx", "rp", "k19"))
    # ids collected before de-dup: around 32, 64 and 128 (the register
    # sort's sizes) and past them
    for m in (31, 32, 33, 64, 65, 128, 129):
        a, b = _distinct_window(rng, pw)
        e.window(a, b)
        _fill_window(e, rng, a, b, m)
    # the most a window can hold: every probe found, every group at its cap
    a, b = _distinct_window(rng, pw)
    e.window(a, b)
    keys = probe_keys(a, b, pw)
    fx.insert(keys["fx0"], _ids(rng, 1)[0])
    rx.insert(keys["rx0"], [e.group(_ids(rng, 4)), 4, _ids(rng, 1)[0]])
    for key in keys["fsub"]:
        fx.insert(key, _ids(rng, 1)[0])
    for key in keys["fdel"]:
        fp.insert(key, [int(rng.integers(0, 1 << 31)), 4])
    for key in keys["fins"] + keys["rins"]:
        k19.insert(key, _ids(rng, 1)[0])
    for key in keys["rsub"]:
        rx.insert(key, [e.group(_ids(rng, 4)), 4, 0])
    for key in keys["rdel"]:
        rp.insert(key, [e.group(_ids(rng, 16)), 16])
    # one id reached by every kind of probe
    a, b = _distinct_window(rng, pw)
    w = e.window(a, b)
    keys = probe_keys(a, b, pw)
    x = _ids(rng, 1)[0]
    fx.insert(keys["fsub"][3], x)
    fx.insert(keys["fsub"][4], x)
    k19.insert(keys["fins"][5], x)
    k19.insert(keys["rins"][6], x)
    fp.insert(keys["fdel"][1], [x - 2, 4])
    rx.insert(keys["rsub"][2], [e.group([x, x, 7, x]), 4, 0])
    rp.insert(keys["rdel"][0], [e.group([5, x] + [x] * 14), 16])
    e.present.append((w, _i32(x)))
    # F-deletion ranges through 2**31 - 1 (= BIG, dropped) into negatives,
    # and a range at the cap with a larger stored count
    a, b = _distinct_window(rng, pw)
    w = e.window(a, b)
    keys = probe_keys(a, b, pw)
    fp.insert(keys["fdel"][0], [0x7FFFFFFE, 4])
    fp.insert(keys["fdel"][1], [1000, 9])
    e.present += [(w, 0x7FFFFFFE), (w, _i32(0x80000000)), (w, 1003)]
    e.absent += [(w, 0x7FFFFFFF), (w, 1004)]
    # gates: F shut (count == minoccur), then R shut, then both; every
    # probe of the window would hit
    for shut in ("f", "r", "fr"):
        a, b = _distinct_window(rng, pw)
        w = e.window(a, b)
        keys = probe_keys(a, b, pw)
        fid, rid = _ids(rng, 2)
        fx.insert(keys["fsub"][0], fid)
        rx.insert(keys["rsub"][0], [e.group([rid]), 1, 0])
        if "f" in shut:
            e.counts[a] = e.minoccur
        if "r" in shut:
            e.counts[b] = e.minoccur - 1
        (e.absent if "f" in shut else e.present).append((w, _i32(fid)))
        (e.absent if "r" in shut else e.present).append((w, _i32(rid)))
    # modes: 0-error keys in both tables (A, or the other mode with
    # full_search), only in R-exact (B), F-exact behind a shut gate (B),
    # an F-exact id equal to BIG (mode A finds no id)
    for kind in ("ab", "b", "shut_a", "big"):
        a, b = _distinct_window(rng, pw)
        e.window(a, b)
        keys = probe_keys(a, b, pw)
        fx.insert(keys["fx0"], 0x7FFFFFFF if kind == "big"
                  else _ids(rng, 1)[0])
        if kind != "big":
            zid = _ids(rng, 1)[0]
            rx.insert(keys["rx0"], [e.group(_ids(rng, 3)), 3, zid])
        if kind == "b":
            fx.keys[fx.keys == keys["fx0"]] = fx.filler()
        if kind == "shut_a":
            e.counts[a] = e.minoccur
        fx.insert(keys["fsub"][1], _ids(rng, 1)[0])
        rp.insert(keys["rdel"][2], [e.group(_ids(rng, 16)), 16])
    # r_ids starts past the end (every member the last id) and two before
    # it (the last id repeated); the groups are made last
    n_before = len(e.r_ids)
    a, b = _distinct_window(rng, pw)
    e.window(a, b)
    keys = probe_keys(a, b, pw)
    tail = _ids(rng, 6)
    e.group(tail)
    n = len(e.r_ids)
    rp.insert(keys["rdel"][0], [n + 5, 16])
    rx.insert(keys["rsub"][0], [n - 2, 4, 0])
    rx.insert(keys["rsub"][1], [n_before, 4, 0])
    return e.build()


def _full_case(rng, pw: int) -> dict:
    """Tables of 16 slots with no EMPTY anywhere: a missing key's chain
    runs 32 slots, twice round the table."""
    e = _EdgeCase("full", pw, bits=4)
    ids = _ids(rng, 64)
    for i in range(12):
        a, b = _distinct_window(rng, pw)
        w = e.window(a, b)
        keys = probe_keys(a, b, pw)
        if i % 3 == 0:
            e.t["fx"].insert(keys["fx0"], ids.pop())
        if i % 3 == 1:
            e.t["rp"].insert(keys["rdel"][i % pw],
                             [e.group(_ids(rng, 16)), 16])
            e.t["k19"].insert(keys["rins"][i], ids.pop())
        if i % 3 == 2:
            e.t["fp"].insert(keys["fdel"][i % pw], [ids.pop() >> 2, 4])
            e.t["rx"].insert(keys["rsub"][i], [e.group(_ids(rng, 4)), 4, 0])
    for t in e.t.values():
        t.fill_all()
    return e.build()


def probe_edges(seed: int = 0, pw: int = 9, n_random: int = 64):
    """The seed probe's edge inputs, each a dict: name, tabs (the
    searchers' layout as numpy: int64 keys, int32 value rows, int32
    r_ids, int64 kmer_counts), pw, w1 / w2 (int64), minoccur, and the
    (window, id) pairs the result must hold (``present``) and must not
    (``absent``) with full_search on or off.  Three cases: ``chains``
    (slots 32 / 33 of a chain, full chains, chains that wrap), ``groups``
    (the caps, the sort sizes, clamped r_ids starts, gates, modes, repeats,
    wrapped ids) and ``full`` (16-slot tables without EMPTY); each also
    holds ``n_random`` random windows."""
    rng = np.random.default_rng(seed)
    out = []
    for make in (_chains_case, _groups_case, _full_case):
        case = make(rng, pw)
        rnd = rng.integers(0, 1 << (2 * pw), (2, n_random))
        case["w1"] = np.concatenate([case["w1"], rnd[0]])
        case["w2"] = np.concatenate([case["w2"], rnd[1]])
        out.append(case)
    return out
