"""BLAST-like report formatting (report_blast.cpp:99-366).

Two formats:
* REGULAR: human-readable pairwise blocks, 60 columns per row
  (report_blast.cpp:136-251) -- the t0 golden-file format.
* TABULAR: m8 12 columns + optional 'cigar', 'qcov', 'qstrand' extras
  (report_blast.cpp:253-354).

Number formatting matches the C++ std::stringstream defaults:
precision(3) -> '%.3g'.
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..constants import NT_MAP
from ..engine.read import Alignment, ReadSeq
from ..stats.refstats import Refstats

_NT = "ACGTN"


def _fmt_g3(x: float) -> str:
    """C++ `ss.precision(3); ss << x` equivalent."""
    return f"{x:.3g}"


def calc_miss_gap_match(ref_seq, read_seq, aln: Alignment):
    """(mismatches, gaps, matches, id_ratio, cov_ratio)
    (Read::calc_miss_gap_match, read.cpp:547-589).

    read_seq must be the 04-encoded read in the ALIGNED orientation.
    M-runs are compared as array slices (the per-character walk of the
    reference is O(len) python and dominates report generation).

    When the batched precompute has run (reports/cigar_stats.py) the
    cached tuple is returned directly.
    """
    m = getattr(aln, "mgm", None)   # getattr: pre-field pickles lack it
    if m is not None:
        return m
    import numpy as np
    n_miss = n_gap = n_match = 0
    qb = aln.ref_begin1
    pb = aln.read_begin1
    for c in aln.cigar:
        op = c & 0xF
        ln = c >> 4
        if op == 0:
            d = int(np.count_nonzero(
                np.asarray(ref_seq[qb:qb + ln])
                != np.asarray(read_seq[pb:pb + ln])))
            n_miss += d
            n_match += ln - d
            qb += ln
            pb += ln
        elif op == 1:
            pb += ln
            n_gap += ln
        else:
            qb += ln
            n_gap += ln
    n_tot = n_miss + n_gap + n_match
    idr = n_match / n_tot if n_tot else 0.0
    cov = abs(aln.read_end1 - aln.read_begin1 + 1) / aln.readlen
    return n_miss, n_gap, n_match, idr, cov


def blast_for_read(read: ReadSeq, alignments: List[Alignment],
                   refs_headers: List[str], refs_seqs, refstats: Refstats,
                   index_num: int, part_num: int, blast_format: str,
                   blastops: List[str], is_print_all_reads: bool) -> str:
    """Render all of this read's alignments matching (index_num, part_num).

    refs_seqs: 04-encoded reference sequences of the loaded part.
    """
    out = []
    for aln in alignments:
        if aln.index_num != index_num or aln.part != part_num:
            continue
        lam, K = refstats.gumbel[index_num]
        bitscore = int(
            _f32(lam * aln.score1 - math.log(K)) / _f32(math.log(2)))
        evalue = refstats.evalue(index_num, aln.score1)
        ref_id = refs_headers[aln.ref_num].split(" ", 1)[0].split("\t", 1)[0]

        if blast_format == "regular":
            out.append(_regular_block(
                read, aln, ref_id, refs_seqs[aln.ref_num],
                read.strand04(aln.strand), aln.score1, bitscore, evalue))
        else:
            # tabular rows only touch the read encoding on an mgm
            # cache miss (cigar_stats precompute covers the sweep)
            read_seq = None if aln.mgm is not None \
                else read.strand04(aln.strand)
            out.append(_tabular_row(
                read, aln, ref_id, refs_seqs[aln.ref_num], read_seq,
                bitscore, evalue, blastops))
    if (is_print_all_reads and not alignments
            and index_num == 0 and part_num == 0):
        row = read.seq_id + "\t*\t0\t0\t0\t0\t0\t0\t0\t0\t0\t0"
        for op in blastops:
            if op == "cigar":
                row += "\t*"
            elif op == "qcov":
                row += "\t0"
            elif op == "qstrand":
                row += "\t*"
        out.append(row + "\n")
    return "".join(out)


def _f32(x: float) -> float:
    import numpy as np
    return float(np.float32(x))


def _tabular_row(read: ReadSeq, aln: Alignment, ref_id: str, ref_seq,
                 read_seq, bitscore: int, evalue: float,
                 blastops: List[str]) -> str:
    miss, gaps, match, idr, cov = calc_miss_gap_match(ref_seq, read_seq, aln)
    parts = [
        read.seq_id,
        ref_id,
        _fmt_g3(idr * 100),
        str(aln.read_end1 - aln.read_begin1 + 1),
        str(miss),
        str(gaps),
        str(aln.read_begin1 + 1),
        str(aln.read_end1 + 1),
        str(aln.ref_begin1 + 1),
        str(aln.ref_end1 + 1),
        _fmt_g3(evalue),
        str(bitscore),
    ]
    row = "\t".join(parts)
    for op in blastops:
        if op == "cigar":
            cig = ""
            if aln.read_begin1 != 0:
                cig += f"{aln.read_begin1}S"
            for c in aln.cigar:
                cig += str(c >> 4) + "MID"[c & 0xF]
            end_mask = aln.readlen - aln.read_end1 - 1
            if end_mask > 0:
                cig += f"{end_mask}S"
            row += "\t" + cig
        elif op == "qcov":
            row += "\t" + _fmt_g3(cov * 100)
        elif op == "qstrand":
            row += "\t" + ("+" if aln.strand else "-")
    return row + "\n"


def _regular_block(read: ReadSeq, aln: Alignment, ref_id: str, ref_seq,
                   read_seq, score1: int, bitscore: int,
                   evalue: float) -> str:
    """Pairwise 60-column rendering (report_blast.cpp:136-251), including
    the reference's exact wrapping-state machinery."""
    MATCH, MISMATCH, INDEL = "|", "*", "-"
    s = []
    s.append(f"Sequence ID: {ref_id}\n")
    s.append(f"Query ID: {read.seq_id}\n")
    s.append(f"Score: {score1} bits ({bitscore})\t")
    s.append(f"Expect: {_fmt_g3(evalue)}\t")
    s.append("strand: " + ("+" if aln.strand else "-") + "\n\n")

    cigar = aln.cigar
    if cigar is not None and len(cigar):
        left = 0
        e = 0
        qb = aln.ref_begin1
        pb = aln.read_begin1
        while e < len(cigar) or left > 0:
            count = 0
            q = qb
            p = pb
            # ---- Target row
            line = "Target: "
            line += f"{q + 1:>8}    "
            done = False
            for c in range(e, len(cigar)):
                letter = cigar[c] & 0xF
                length = cigar[c] >> 4
                l = left if (count == 0 and left > 0) else length
                for j in range(l):
                    if letter == 1:
                        line += INDEL
                    else:
                        line += _NT[ref_seq[q]]
                        q += 1
                    count += 1
                    if count == 60:
                        done = True
                        break
                if done:
                    break
            s.append(line + f"    {q}\n")
            # ---- match row
            s.append(" " * 20)
            q = qb
            count = 0
            p = pb
            line = ""
            done = False
            for c in range(e, len(cigar)):
                letter = cigar[c] & 0xF
                length = cigar[c] >> 4
                l = left if (count == 0 and left > 0) else length
                for j in range(l):
                    if letter == 0:
                        # nt_map[ref] == nt_map[read] (report_blast.cpp:197)
                        if ref_seq[q] == read_seq[p]:
                            line += MATCH
                        else:
                            line += MISMATCH
                        q += 1
                        p += 1
                    else:
                        line += " "
                        if letter == 1:
                            p += 1
                        else:
                            q += 1
                    count += 1
                    if count == 60:
                        qb = q
                        done = True
                        break
                if done:
                    break
            s.append(line)
            # ---- Query row
            p = pb
            line = f"\nQuery: {p + 1:>9}    "
            count = 0
            done = False
            for c in range(e, len(cigar)):
                letter = cigar[c] & 0xF
                length = cigar[c] >> 4
                l = left if (count == 0 and left > 0) else length
                for j in range(l):
                    if letter == 2:
                        line += INDEL
                    else:
                        line += _NT[read_seq[p]]
                        p += 1
                    count += 1
                    if count == 60:
                        pb = p
                        left = l - j - 1
                        e = c + 1 if left == 0 else c
                        done = True
                        break
                if done:
                    break
            if not done:
                e = len(cigar)
                left = 0
            s.append(line + f"    {p}\n\n")
    return "".join(s)
