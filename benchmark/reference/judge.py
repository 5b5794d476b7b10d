"""The comparison that decides ``correct``.

Each timed job is judged from its own outputs (``aligned.fq`` and
``other.fq``, or with ``-out2`` their ``_fwd`` and ``_rev`` files;
``aligned.blast``, ``aligned.log``) against the job's input files, the
database files, the generator's own record of which reads (or pairs)
were cut from a database, and the reference's own Gumbel lambda and K
of each database (``gumbel.py``).  A mate of a pair is judged as the
single read it is; ``judge`` says how pairs are filed.  Over every read
and every BLAST row:

- ``reads_misfiled``: reads missing from both outputs, in both, written
  twice, unknown, in the other mate's file, or whose record differs
  from the input's; mates filed apart from their pair under
  ``-paired_in``; and aligned reads whose row's CIGAR scores below its
  database's minimal SW score;
- ``log_mismatches``: fields of ``aligned.log`` (read counts, shares,
  lengths; each database's minimal SW score and coverage) that differ
  from the reference's;
- ``rrna_in_other``: reads cut from a member that were filed as other,
  and under ``-paired_in`` also those without a row of their own;
- ``blast_mismatches``: aligned reads without exactly one BLAST row (at
  most one under ``-paired_in``), rows of other reads, and fields of a
  row that disagree with its own CIGAR laid on the read and the
  reference;
- ``evalue_log_err_max``: the largest |ln E_printed - ln E_reference|,
  E_reference = K m' n' exp(-lambda S) with S the CIGAR's score and m',
  n' the length-corrected search space of the row's database worked out
  here;
- ``bits_err_max``: the largest gap between the printed and the
  reference's bit score;
- ``lambda_rel_err``, ``K_log_err``: how far the lambda and K that
  ``aligned.log`` states for each database lie from the reference's own
  estimate, |lambda / lambda_ref - 1| and |ln(K / K_ref)|, the largest
  over the databases.

E, bits and the minimal score are worked out with the log's lambda and
K of the row's database, so that they test the program's arithmetic to
its rounding; the two numbers above hold those lambda and K to the
reference's own.

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
from typing import Dict, List, Sequence, Tuple

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


JOB_FIELDS = {
    "total": r"Total reads = (\d+)",
    "passing": r"passing E-value threshold = (\d+) \(([\d.]+)\)",
    "failing": r"failing E-value threshold = (\d+) \(([\d.]+)\)",
    "min_len": r"Minimum read length = (\d+)",
    "max_len": r"Maximum read length = (\d+)",
    "mean_len": r"Mean read length\s+= (\d+)",
}
DB_FIELDS = {
    "lambda": r"Gumbel lambda = ([\d.eE+-]+)",
    "K": r"Gumbel K = ([\d.eE+-]+)",
    "minimal": r"Minimal SW score based on E-value = (-?\d+)",
}


def _fields(pats: Dict[str, str], txt: str) -> Dict[str, tuple]:
    got = {}
    for k, p in pats.items():
        m = re.search(p, txt)
        got[k] = m.groups() if m else None
    return got


def read_log(path: str) -> dict:
    """The fields of ``aligned.log`` that the judge compares: the job's
    (each the groups of its pattern, None where it is missing); under
    ``db`` each ``Reference file:`` block's lambda, K and minimal score;
    under ``coverage`` each "Coverage by database" line's share; both
    in the order the log gives them."""
    txt = open(path).read()
    got = _fields(JOB_FIELDS, txt)
    got["db"] = [_fields(DB_FIELDS, block)
                 for block in txt.split("Reference file: ")[1:]]
    lines = txt.partition("Coverage by database:\n")[2].split("\n\n")[0]
    got["coverage"] = [m.groups() for m in
                       re.finditer(r"^\s+\S+\t\t([\d.]+)$", lines, re.M)]
    return got


UNJUDGED = ("-paired", "-paired_out", "-sout")


def output_names(flags: Sequence[str], paired: bool) -> Tuple[List[str],
                                                               List[str]]:
    """The files that aligned and other reads go to under the
    configuration's flags: one of each, or with ``-out2`` one for each
    mate.  Flags whose routing the judge does not implement raise."""
    bad = sorted(set(UNJUDGED) & set(flags))
    if bad:
        raise ValueError(f"the judge does not implement {bad}")
    if "-out2" not in flags:
        return ["aligned.fq"], ["other.fq"]
    if not paired:
        raise ValueError("-out2 needs paired reads")
    return (["aligned_fwd.fq", "aligned_rev.fq"],
            ["other_fwd.fq", "other_rev.fq"])


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



P_MOVED = 1e-9      # a sound job's chance of failing the coverage rule


def moved_bound(n_dbs: int, evalue: float) -> Tuple[int, int]:
    """(gain, moved): the most reads that a sound job counts on one
    database beyond its rows there, and the most it counts on an
    earlier database than the one its row is on, over all databases
    (``coverage_mismatches``), each exceeded with probability under
    ``P_MOVED``.  Such a read has an alignment above the minimal score
    on the earlier database besides its best; the databases are
    unrelated synthetic sequence, so that alignment is one by chance,
    and the minimal score admits at most ``evalue`` of those expected
    over a job's reads and one database: Poisson with mean at most
    ``evalue`` on one database, and ``(n - 1) evalue`` over the n - 1
    that have a later one.  Sound runs on the card read at most one
    moved read a job (PERF.md)."""
    from scipy.stats import poisson
    if n_dbs < 2:
        return 0, 0
    return (int(poisson.isf(P_MOVED, evalue)),
            int(poisson.isf(P_MOVED, (n_dbs - 1) * evalue)))


def _counts_printed(got: tuple, n: int, total: int, lo: int,
                    hi: int) -> List[int]:
    """The changes d, lo <= d <= hi, for which ``n + d`` reads of
    ``total`` print the share ``got``."""
    if not got:
        return []
    step = total // 10000 + 3         # reads a printed 0.01% spans, and more
    c0 = int(round(float(got[0]) / 100 * total))
    return [c - n for c in range(max(c0 - step, 0), c0 + step + 1)
            if lo <= c - n <= hi and (_pct(c, total),) == got]


def fewest_moved(printed: Sequence[tuple], rows_on: Sequence[int],
                 total: int, gain: int = -1, moved: int = -1):
    """The fewest reads that, moved from the database of their row to
    an earlier one, make the program's counts print the "Coverage by
    database" lines: database d counts ``rows_on[d] + delta[d]``, every
    prefix sum of delta is at least 0, delta sums to 0, and the reads
    moved are the sum of its positive parts.  Each database gains at
    most ``gain`` and loses at most ``moved`` (no limit where -1).
    Returns (the lines that no count within those limits prints, the
    fewest moved or None where no delta prints every line)."""
    lo = -(moved if moved >= 0 else total)
    hi = gain if gain >= 0 else total
    options = [_counts_printed(got, n, total, lo, hi)
               for got, n in zip(printed, rows_on)]
    bad = sum(1 for o in options if not o) + abs(len(printed) - len(rows_on))
    if bad:
        return bad, None
    best = {0: 0}           # prefix sum -> fewest reads moved so far
    for o in options:
        nxt: Dict[int, int] = {}
        for s, m in best.items():
            for d in o:
                if s + d >= 0 and m + max(d, 0) < nxt.get(s + d, total + 1):
                    nxt[s + d] = m + max(d, 0)
        best = nxt
    return 0, best.get(0)


def coverage_mismatches(printed: Sequence[tuple], rows_on: Sequence[int],
                        total: int, gain: int, moved: int) -> int:
    """The "Coverage by database" lines that no sound count gives.

    The program counts a read on the first database, in ``-ref`` order,
    that aligns it, and when a later one aligns it better the count
    stays (alignment.cpp:454, the port's native/engine.cpp:509-512):
    under ``-num_alignments 1`` too, since the replace-min step runs
    whenever a later database scores higher.  So database d counts the
    reads with a row on it, moved as ``fewest_moved`` says, each
    database gaining at most ``gain`` and at most ``moved`` moving in
    all (``moved_bound``).  A line counts when no count within those
    limits prints it, and one more when no delta prints all lines;
    with one database (both limits 0) each line is held to its rows'
    share exactly."""
    bad, fewest = fewest_moved(printed, rows_on, total, gain, moved)
    if bad:
        return bad
    return 0 if fewest is not None and fewest <= moved else 1


def judge(jobs: Sequence[dict], dbs: Sequence[Database],
          flags: Sequence[str], scoring: dict, evalue: float, edges: int,
          sample: int, seed: int, gumbel_refs: Sequence[tuple],
          device="cpu") -> Dict[str, float]:
    """``jobs``: dicts with ``fastq`` (the input files: one, or a pair's
    two), ``out`` (the job's output directory) and ``is_rrna`` (a bool
    per read, or per pair); ``dbs``: the databases in ``-ref`` order;
    ``gumbel_refs``: the reference's own (lambda, K) of each
    (``gumbel.cached``).

    Pairs: with ``-out2`` mate 1 is judged in the ``_fwd`` files and
    mate 2 in the ``_rev`` ones, each record against its own input.
    With ``-paired_in`` both mates go to aligned when either has a row,
    else both to other: a mate filed apart counts in ``reads_misfiled``,
    and each mate of an rRNA pair in other, or without a row of its
    own, in ``rrna_in_other``.
    Without it each mate is filed as a single read."""
    name_of = {n: (d, i) for d, db in enumerate(dbs)
               for i, n in enumerate(db.names)}
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    num = dict(reads_misfiled=0, log_mismatches=0, rrna_in_other=0,
               blast_mismatches=0, window_gap_max=0,
               evalue_log_err_max=0.0, bits_err_max=0,
               lambda_rel_err=0.0, K_log_err=0.0, rows_checked=0, rows=0)
    if len(dbs) > 1:
        num["moved_max"] = 0     # not compared: fewest_moved's, for PERF.md
    freqs = [composition(db) for db in dbs]
    sampled = []       # per job: (score, read, reference, diagonals)
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    for k, job in enumerate(jobs):
        inps = []
        for path in job["fastq"]:
            with gzip.open(path, "rb") as fh:
                inps.append(parse_fastq(fh.read()))
        paired = len(inps) == 2
        pair_in = paired and "-paired_in" in flags
        inp = {rid: rec for one in inps for rid, rec in one.items()}
        ids = list(inp)
        names_al, names_ot = output_names(flags, paired)
        # each output file against its own input: mate 1's with -out2
        own = inps if len(names_al) == 2 else [inp]
        filed = []
        for names in (names_al, names_ot):
            got: Dict[bytes, bytes] = {}
            for name, want in zip(names, own):
                out = parse_fastq(open(f"{job['out']}/{name}", "rb").read())
                num["reads_misfiled"] += sum(
                    1 for rid, rec in out.items()
                    if rec is None or want.get(rid) != rec)
                got.update(out)
            filed.append(got)
        al, ot = filed
        num["reads_misfiled"] += sum(1 for rid in ids
                                     if (rid in al) == (rid in ot))
        rrna = {rid for one in inps
                for rid, t in zip(one, job["is_rrna"]) if t}
        if not pair_in:
            num["rrna_in_other"] += sum(1 for rid in ot if rid in rrna)

        log = read_log(f"{job['out']}/aligned.log")
        lens = np.array([len(inp[rid].split(b"\n")[1]) for rid in ids])
        try:
            if len(log["db"]) != len(dbs):
                raise ValueError("a Reference file block per database")
            gumbel = [(float(b["lambda"][0]), float(b["K"][0]))
                      for b in log["db"]]
        except (TypeError, ValueError):
            num["log_mismatches"] += 10
            continue
        for (lam, K), (lam_ref, K_ref) in zip(gumbel, gumbel_refs):
            num["lambda_rel_err"] = max(num["lambda_rel_err"],
                                        abs(lam / lam_ref - 1))
            num["K_log_err"] = max(num["K_log_err"],
                                   abs(math.log(K / K_ref)))
        # each database's search space: its own m and member count, the
        # reads of the whole job (both mates), its own lambda and K
        spaces = [SearchSpace(db, f, lam, K, len(ids), int(lens.sum()),
                              evalue)
                  for db, f, (lam, K) in zip(dbs, freqs, gumbel)]

        # every row: its fields against its CIGAR, its E-value and bits
        # against its CIGAR's score, and that score at least its
        # database's minimal
        seen: Dict[bytes, int] = {}
        hit_on = [set() for _ in dbs]    # reads with a row, by database
        rows = []
        for line in open(f"{job['out']}/aligned.blast", "rb"):
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) >= 2 and f[0] in inp and f[1].decode() in name_of:
                hit_on[name_of[f[1].decode()][0]].add(f[0])
            if len(f) != 15 or f[0] not in al or f[1].decode() not in \
                    name_of:
                num["blast_mismatches"] += 1
                continue
            seen[f[0]] = seen.get(f[0], 0) + 1
            d, member = name_of[f[1].decode()]
            ref, space = dbs[d].seqs[member], spaces[d]
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
        hits = set().union(*hit_on)
        if pair_in:
            # one row at most a read; a pair with a row on either mate is
            # aligned, both mates
            num["blast_mismatches"] += sum(1 for rid in al
                                           if seen.get(rid, 0) > 1)
            for a, b in zip(*inps):
                hit = a in hits or b in hits
                num["reads_misfiled"] += sum(
                    1 for rid in (a, b)
                    if (rid in al) != (rid in ot) and (rid in al) != hit)
            # each rRNA mate aligns on its own: one filed with its pair
            # but without a row of its own counts, as one in other does
            num["rrna_in_other"] += sum(1 for rid in rrna
                                        if rid in ot or rid not in hits)
        else:
            num["blast_mismatches"] += sum(1 for rid in al
                                           if seen.get(rid, 0) != 1)
        num["rows"] += len(rows)
        sampled.append(rows)

        # the log: the job's counts over all reads, both mates; passing
        # is the reads with a row (readstats.num_aligned), which -paired_in
        # does not widen to the mates filed with them
        n_al = len(hits)
        share = float(np.float32(n_al) / np.float32(len(ids)))
        want = {"total": (str(len(ids)),),
                "passing": (str(n_al), _pct(n_al, len(ids))),
                "failing": (str(len(ids) - n_al),
                            f"{(1 - share) * 100:.2f}"),
                "min_len": (str(lens.min()),), "max_len": (str(lens.max()),),
                "mean_len": (str(int(lens.sum()) // len(ids)),)}
        num["log_mismatches"] += sum(log[k2] != v for k2, v in want.items())
        num["log_mismatches"] += sum(
            b["minimal"] != (str(sp.minimal),)
            for b, sp in zip(log["db"], spaces))
        rows_on = [len(h) for h in hit_on]
        num["log_mismatches"] += coverage_mismatches(
            log["coverage"], rows_on, len(ids),
            *moved_bound(len(dbs), evalue))
        if len(dbs) > 1:
            got = fewest_moved(log["coverage"], rows_on, len(ids))[1]
            num["moved_max"] = None if got is None or \
                num["moved_max"] is None else max(num["moved_max"], got)

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
