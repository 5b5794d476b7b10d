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
    qlen[:4] = [1, Lq, 1, Lq]
    rlen[:4] = [1, 1, Lr, Lr]
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
    Q[np.arange(lq)[None] >= ql[:, None]] = 0
    R[np.arange(lr)[None] >= rl[:, None]] = 0
    buf = np.empty((B, lq // 2 + lr // 2 + 12), np.uint8)
    buf[:, :lq // 2] = (Q[:, ::2] << 4) | Q[:, 1::2]
    buf[:, lq // 2:lq // 2 + lr // 2] = (R[:, ::2] << 4) | R[:, 1::2]
    ints = np.stack([ql.astype(np.int32), rl.astype(np.int32), minimal], 1)
    buf[:, lq // 2 + lr // 2:] = ints.astype("<i4").view(np.uint8)
    return buf


def read_outputs(out_dir: str, paths: Sequence[str] = ()) -> dict:
    """The reports of one run, normalised for comparison across runs:
    aligned.sam without its @PG line (it carries the command line);
    aligned.log without the Command, pid and date lines and with each of
    ``paths`` (run-specific directories) replaced by ``<dir>``."""
    got = {}
    for name in ("aligned.blast", "aligned.fa", "other.fa", "otu_map.txt",
                 "aligned_denovo.fa"):
        p = os.path.join(out_dir, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                got[name] = f.read()
    p = os.path.join(out_dir, "aligned.sam")
    if os.path.exists(p):
        with open(p, "rb") as f:
            got["aligned.sam"] = b"".join(
                ln for ln in f if not ln.startswith(b"@PG"))
    p = os.path.join(out_dir, "aligned.log")
    if os.path.exists(p):
        with open(p) as f:
            lines = f.read().splitlines(keepends=True)
        keep = []
        skip_next = False
        for ln in lines:
            if skip_next:           # the command line under " Command:"
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
        got["aligned.log"] = "".join(keep)
    return got
