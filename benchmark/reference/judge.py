"""The comparison that decides ``correct``.

Each timed job is judged from its own outputs (``aligned.fq``,
``other.fq``, ``aligned.blast``, ``aligned.log``) against the job's
input file, the database file, the generator's own record of which
reads were cut from the database, and the reference's own Gumbel
lambda and K (``gumbel.py``).  Over every read and every BLAST row:

- ``reads_misfiled``: reads missing from both outputs, in both, written
  twice, unknown, or whose record differs from the input's; and aligned
  reads whose row's CIGAR scores below the minimal SW score;
- ``log_mismatches``: fields of ``aligned.log`` (read counts, shares,
  lengths, the minimal SW score) that differ from the reference's;
- ``rrna_in_other``: reads cut from a member that were filed as other;
- ``blast_mismatches``: aligned reads without exactly one BLAST row,
  rows of other reads, and fields of a row that disagree with its own
  CIGAR laid on the read and the reference;
- ``evalue_log_err_max``: the largest |ln E_printed - ln E_reference|,
  E_reference = K m' n' exp(-lambda S) with S the CIGAR's score and m',
  n' the length-corrected search space worked out here;
- ``bits_err_max``: the largest gap between the printed and the
  reference's bit score;
- ``lambda_rel_err``, ``K_log_err``: how far the lambda and K that
  ``aligned.log`` states lie from the reference's own estimate,
  |lambda / lambda_ref - 1| and |ln(K / K_ref)|.

E, bits and the minimal score are worked out with the log's lambda and
K, so that they test the program's arithmetic to its rounding; the two
numbers above hold those lambda and K to the reference's own.

Over a sample of rows drawn from the seed, the longest reads in it:

- ``window_gap_max``: the widest gap between a row's CIGAR score and
  the plain Smith-Waterman optimum of the read (in the row's strand) on
  the window of the reported reference that sortmerna cuts around a
  seed (``sortmerna_window``, alignment.cpp:283-357), taken on the
  nearest of the seed's possible diagonals: those of the alignment's
  matched runs and one either side (a seed matches within one edit, an
  indel at its edge included).  The program aligns exactly there, so a
  sound row reads 0; an alignment ended early, or a score that is not
  the window's optimum, reads more.
"""

from __future__ import annotations

import gzip
import math
import re
from typing import Dict, List, Sequence

import numpy as np

from . import sw
from .generate import Database

NUMBERS = ("reads_misfiled", "log_mismatches", "blast_mismatches",
           "rrna_in_other", "window_gap_max", "evalue_log_err_max",
           "bits_err_max", "lambda_rel_err", "K_log_err")


def parse_fastq(data: bytes) -> Dict[bytes, bytes]:
    """id -> whole record; a repeated id maps to None."""
    lines = data.split(b"\n")
    out: Dict[bytes, bytes] = {}
    for i in range(0, len(lines) - 3, 4):
        rid = lines[i][1:].split()[0]
        rec = b"\n".join(lines[i:i + 4])
        out[rid] = None if rid in out else rec
    return out


def read_log(path: str) -> Dict[str, str]:
    txt = open(path).read()
    pats = {
        "total": r"Total reads = (\d+)",
        "passing": r"passing E-value threshold = (\d+) \(([\d.]+)\)",
        "failing": r"failing E-value threshold = (\d+) \(([\d.]+)\)",
        "min_len": r"Minimum read length = (\d+)",
        "max_len": r"Maximum read length = (\d+)",
        "mean_len": r"Mean read length\s+= (\d+)",
        "lambda": r"Gumbel lambda = ([\d.eE+-]+)",
        "K": r"Gumbel K = ([\d.eE+-]+)",
        "minimal": r"Minimal SW score based on E-value = (-?\d+)",
        "coverage": r"Coverage by database:\n\s+\S+\t\t([\d.]+)",
    }
    got = {}
    for k, p in pats.items():
        m = re.search(p, txt)
        got[k] = m.groups() if m else None
    return got


def _pct(a: int, b: int) -> str:
    return f"{float(np.float32(a) / np.float32(b)) * 100:.2f}" if b \
        else "0.00"


def composition(db: Database) -> np.ndarray:
    """The database's base frequencies, A C G T."""
    counts = np.bincount(np.concatenate(db.seqs), minlength=5)[:4]
    return counts / counts.sum()


class SearchSpace:
    """m', n' and the minimal score (the length correction of the
    E-value's search space) for one job."""

    def __init__(self, db: Database, freqs: np.ndarray, lam: float,
                 K: float, n_reads: int, reads_len: int, evalue: float):
        entropy = float(-(freqs * np.log2(freqs)).sum())
        m, n = db.total_len, reads_len
        expect = int(math.log(K * m * n) / entropy)
        if m > expect * len(db.seqs):
            m -= expect * len(db.seqs)
        n -= expect * n_reads
        self.m, self.n, self.lam, self.K = m, n, lam, K
        self.minimal = int(math.log(evalue / (K * m * n)) / -lam)

    def log_evalue(self, score: int) -> float:
        return (math.log(self.K) + math.log(self.m) + math.log(self.n)
                - self.lam * score)

    def bits(self, score: int) -> int:
        return int(np.float32(self.lam * score - math.log(self.K))
                   / np.float32(math.log(2)))


_CIGAR = re.compile(rb"(\d+)([MIDS])")


def check_row(f: List[bytes], read: np.ndarray, ref: np.ndarray,
              scoring: dict) -> tuple:
    """Lay one BLAST row's CIGAR on the read (in the row's strand) and
    the reference.  Returns (fields that disagree, the CIGAR's score, the
    whole read in the row's strand, the diagonals ref - read position
    that the alignment's matched runs lie on)."""
    bad = 0
    strand = f[14]
    q = read if strand == b"+" else (3 - read)[::-1]
    qs, qe, ss, se = (int(x) - 1 for x in f[6:10])
    ops = [(int(n), o) for n, o in _CIGAR.findall(f[12])]
    if b"".join(b"%d%s" % op for op in ops) != f[12]:
        return 1, None, None, None
    lead = ops[0][0] if ops and ops[0][1] == b"S" else 0
    trail = ops[-1][0] if ops and ops[-1][1] == b"S" else 0
    core = ops[(1 if lead else 0):len(ops) - (1 if trail else 0)]
    bad += lead != qs
    bad += trail != len(q) - qe - 1
    i, j = qs, ss
    miss = match = gaps = 0
    score = 0
    diags = []
    for n, o in core:
        if o == b"M":
            a, b = q[i:i + n], ref[j:j + n]
            if len(a) != n or len(b) != n:
                return bad + 1, None, None, None
            if j - i not in diags:
                diags.append(j - i)
            d = int(np.count_nonzero(a != b))
            miss += d
            match += n - d
            score += (n - d) * scoring["match"] + d * scoring["mismatch"]
            i += n
            j += n
        elif o in (b"I", b"D"):
            gaps += n
            score -= scoring["gap_open"] + (n - 1) * scoring["gap_ext"]
            if o == b"I":
                i += n
            else:
                j += n
        else:
            return bad + 1, None, None, None
    bad += i != qe + 1
    bad += j != se + 1
    tot = miss + gaps + match
    bad += f[2] != (f"{100 * match / tot:.3g}" if tot else "0").encode()
    bad += int(f[3]) != qe - qs + 1
    bad += int(f[4]) != miss
    bad += int(f[5]) != gaps
    bad += f[13] != f"{100 * (qe - qs + 1) / len(q):.3g}".encode()
    return bad, score, q, diags


def sortmerna_window(q: np.ndarray, ref: np.ndarray, d: int,
                     edges: int) -> tuple:
    """The part of the read and of the reference that sortmerna hands to
    Smith-Waterman for a seed on diagonal ``d`` (reference position
    minus read position), as alignment.cpp:283-357 cuts them: the
    reference around the read's projection, ``edges`` more on each side
    where it has them, the read cut where it overhangs."""
    readlen, reflen = len(q), len(ref)
    head = tail = 0
    if d < 0:
        ref_start, que_start = 0, -d
        if reflen < readlen:
            if que_start > readlen - reflen:
                length = reflen - (que_start - (readlen - reflen))
            else:
                length = reflen
        else:
            tail = min(reflen - readlen, edges)
            length = readlen + tail - que_start
    else:
        ref_start, que_start = d, 0
        if ref_start > edges - 1:
            head = edges
        if ref_start + readlen > reflen:
            length = reflen - ref_start - head
        else:
            tail = min(reflen - ref_start - readlen, edges)
            length = readlen + head + tail
    rs = ref_start - head
    return (q[que_start:que_start + max(length - head - tail, 0)],
            ref[rs:rs + max(length, 0)])




def judge(jobs: Sequence[dict], db: Database, scoring: dict, evalue: float,
          edges: int, sample: int, seed: int, gumbel_ref: tuple,
          device="cpu") -> Dict[str, float]:
    """``jobs``: dicts with ``fastq`` (the input file), ``out`` (the
    job's output directory) and ``is_rrna``; ``gumbel_ref``: the
    reference's own (lambda, K) (``gumbel.cached``)."""
    name_of = {n: i for i, n in enumerate(db.names)}
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    num = dict(reads_misfiled=0, log_mismatches=0, rrna_in_other=0,
               blast_mismatches=0, window_gap_max=0,
               evalue_log_err_max=0.0, bits_err_max=0,
               lambda_rel_err=0.0, K_log_err=0.0, rows_checked=0, rows=0)
    freqs = composition(db)
    lam_ref, K_ref = gumbel_ref
    sampled = []       # per job: (score, read, reference, diagonals)
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    for k, job in enumerate(jobs):
        with gzip.open(job["fastq"], "rb") as fh:
            inp = parse_fastq(fh.read())
        ids = list(inp)
        al = parse_fastq(open(f"{job['out']}/aligned.fq", "rb").read())
        ot = parse_fastq(open(f"{job['out']}/other.fq", "rb").read())
        for out in (al, ot):
            num["reads_misfiled"] += sum(
                1 for rid, rec in out.items()
                if rec is None or inp.get(rid) != rec)
        num["reads_misfiled"] += sum(1 for rid in ids
                                     if (rid in al) == (rid in ot))
        rrna = {rid for rid, t in zip(ids, job["is_rrna"]) if t}
        num["rrna_in_other"] += sum(1 for rid in ot if rid in rrna)

        log = read_log(f"{job['out']}/aligned.log")
        lens = np.array([len(inp[rid].split(b"\n")[1]) for rid in ids])
        try:
            lam, K = float(log["lambda"][0]), float(log["K"][0])
        except (TypeError, ValueError):
            num["log_mismatches"] += 10
            continue
        num["lambda_rel_err"] = max(num["lambda_rel_err"],
                                    abs(lam / lam_ref - 1))
        num["K_log_err"] = max(num["K_log_err"], abs(math.log(K / K_ref)))
        space = SearchSpace(db, freqs, lam, K, len(ids), int(lens.sum()),
                            evalue)
        n_al = len(al)
        share = float(np.float32(n_al) / np.float32(len(ids)))
        want = {"total": (str(len(ids)),),
                "passing": (str(n_al), _pct(n_al, len(ids))),
                "failing": (str(len(ids) - n_al),
                            f"{(1 - share) * 100:.2f}"),
                "min_len": (str(lens.min()),), "max_len": (str(lens.max()),),
                "mean_len": (str(int(lens.sum()) // len(ids)),),
                "minimal": (str(space.minimal),),
                "coverage": (_pct(n_al, len(ids)),)}
        num["log_mismatches"] += sum(log[k2] != v for k2, v in want.items())

        # every row: its fields against its CIGAR, its E-value and bits
        # against its CIGAR's score, and that score at least the minimal
        seen: Dict[bytes, int] = {}
        rows = []
        for line in open(f"{job['out']}/aligned.blast", "rb"):
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) != 15 or f[0] not in al or f[1].decode() not in \
                    name_of:
                num["blast_mismatches"] += 1
                continue
            seen[f[0]] = seen.get(f[0], 0) + 1
            ref = db.seqs[name_of[f[1].decode()]]
            read = lut[np.frombuffer(inp[f[0]].split(b"\n")[1], np.uint8)]
            bad, score, q, diags = check_row(f, read, ref, scoring)
            num["blast_mismatches"] += bad
            if score is None:
                continue
            num["reads_misfiled"] += score < space.minimal
            printed = float(f[10])
            want_ln = space.log_evalue(score)
            if want_ln < -700:           # past double's range: printed ~ 0
                err = 0.0 if printed < 1e-300 else abs(want_ln)
            else:
                err = abs(math.log(printed) - want_ln) if printed > 0 \
                    else abs(want_ln)
            num["evalue_log_err_max"] = max(num["evalue_log_err_max"], err)
            num["bits_err_max"] = max(num["bits_err_max"],
                                      abs(int(f[11]) - space.bits(score)))
            rows.append((score, q, ref, diags))
        num["blast_mismatches"] += sum(1 for rid in al
                                       if seen.get(rid, 0) != 1)
        num["rows"] += len(rows)
        sampled.append(rows)

    # the sample for the plain SW: the longest reads, then a draw from
    # the seed; each row against sortmerna's window on each diagonal its
    # seed may lie on
    rows = [r for rs in sampled for r in rs]
    by_len = np.argsort([-len(r[1]) for r in rows], kind="stable")
    pick = list(by_len[:32])
    rest = by_len[32:]
    if len(rest):
        pick += list(rng.choice(rest, size=min(sample, len(rest)),
                                replace=False))
    owner, queries, refs = [], [], []
    for k, p in enumerate(pick):
        score, q, ref, diags = rows[p]
        for d in sorted({d + e for d in diags for e in (-1, 0, 1)}):
            wq, wr = sortmerna_window(q, ref, d, edges)
            owner.append(k)
            queries.append(wq)
            refs.append(wr)
    best = sw.best_scores(queries, refs, scoring["match"],
                          scoring["mismatch"], scoring["gap_open"],
                          scoring["gap_ext"], device=device)
    gap = np.full(len(pick), np.iinfo(np.int64).max, np.int64)
    for k, b in zip(owner, best):
        gap[k] = min(gap[k], abs(int(b) - rows[pick[k]][0]))
    if len(pick):
        num["window_gap_max"] = int(gap.max())
    num["rows_checked"] = len(pick)
    return num
