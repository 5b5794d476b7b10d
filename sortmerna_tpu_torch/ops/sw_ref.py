"""Smith-Waterman scoring and CIGAR traceback -- host reference backend.

Numpy implementation reproducing the reference's SSW semantics (ssw.c):

* ``sw_score``: local alignment score + end coordinates.  Recurrence
  (sw_sse2_byte, ssw.c:150-373):  opening a gap costs gap_open for its
  FIRST character (H - gapO), extension costs gap_ext (so a length-L gap
  costs gapO + (L-1)*gapE).  The returned end_ref is the EARLIEST column
  attaining the global max (strict '>' update, ssw.c:310-318); end_read is
  the MINIMUM row with H == max within that column (ssw.c:327-336).
* ``sw_begin``: the reverse pass locating the alignment start
  (ssw_align, ssw.c:900-918): run the same kernel on the reversed
  prefixes, stopping at the first column whose max equals the known score.
* ``banded_sw_traceback``: banded DP + traceback generating the CIGAR with
  the reference's exact tie-breaking (banded_sw, ssw.c:577-773):
  E/F prefer EXTEND on ties, H prefers DIAGONAL on ties, E-vs-F tie goes
  to F's direction; the first read row is always emitted as M.

Coordinates are 0-based; CIGAR is a list of (length, op) with op in
{0: M, 1: I (read gap consumed), 2: D (ref consumed)} -- ssw.h:52-54.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def sw_score(query: np.ndarray, ref: np.ndarray, mat: np.ndarray,
             gap_open: int, gap_ext: int) -> Tuple[int, int, int]:
    """Return (score, end_ref, end_read); end_* are -1/readLen-1 when no
    positive-scoring cell exists (matching ssw.c:171-172 init)."""
    m = len(query)
    n = len(ref)
    NEG = -10**9
    Hprev = np.zeros(m, dtype=np.int64)
    E = np.full(m, NEG, dtype=np.int64)   # gap along ref (horizontal)
    best = 0
    end_ref = -1
    end_read = m - 1
    qprof = mat[:, query]   # [5, m] score of ref-char r vs query col
    for j in range(n):
        diag = np.empty(m, dtype=np.int64)
        diag[0] = qprof[ref[j], 0]
        diag[1:] = Hprev[:-1] + qprof[ref[j], 1:]
        E = np.maximum(E - gap_ext, Hprev - gap_open)
        Hpre = np.maximum.reduce([np.zeros(m, dtype=np.int64), diag, E])
        # F via prefix max: F[i] = max_{k<i} (H[k] - gapO - (i-1-k)*gapE)
        # valid because gapO >= gapE makes re-opening inside a gap
        # never beneficial.
        g = Hpre - gap_open + np.arange(m) * gap_ext
        gmax = np.maximum.accumulate(g)
        F = np.full(m, NEG, dtype=np.int64)
        if m > 1:
            F[1:] = gmax[:-1] - np.arange(0, m - 1) * gap_ext
        H = np.maximum(Hpre, F)
        colmax = int(H.max())
        if colmax > best:
            best = colmax
            end_ref = j
            end_read = int(np.argmax(H == colmax))
        Hprev = H
    return best, end_ref, end_read


def sw_begin(query: np.ndarray, ref: np.ndarray, mat: np.ndarray,
             gap_open: int, gap_ext: int, score: int,
             end_ref: int, end_read: int) -> Tuple[int, int]:
    """Reverse pass: find (ref_begin, read_begin), 0-based.

    Mirrors ssw_align (ssw.c:900-918): align reversed query[0:end_read+1]
    against reversed ref[0:end_ref+1]; the first column (scanning from
    end_ref backwards) whose max equals ``score`` gives ref_begin; the
    minimal row index in that scan gives read_begin = end_read - row.
    """
    q = query[end_read::-1]
    r = ref[end_ref::-1]
    m = len(q)
    NEG = -10**9
    Hprev = np.zeros(m, dtype=np.int64)
    E = np.full(m, NEG, dtype=np.int64)
    best = 0
    best_col = -1
    best_row = m - 1
    qprof = mat[:, q]
    for j in range(len(r)):
        diag = np.empty(m, dtype=np.int64)
        diag[0] = qprof[r[j], 0]
        diag[1:] = Hprev[:-1] + qprof[r[j], 1:]
        E = np.maximum(E - gap_ext, Hprev - gap_open)
        Hpre = np.maximum.reduce([np.zeros(m, dtype=np.int64), diag, E])
        g = Hpre - gap_open + np.arange(m) * gap_ext
        gmax = np.maximum.accumulate(g)
        F = np.full(m, NEG, dtype=np.int64)
        if m > 1:
            F[1:] = gmax[:-1] - np.arange(0, m - 1) * gap_ext
        H = np.maximum(Hpre, F)
        colmax = int(H.max())
        if colmax > best:
            best = colmax
            best_col = j
            best_row = int(np.argmax(H == colmax))
        if colmax == score:      # terminate (ssw.c:324)
            break
        Hprev = H
    ref_begin = end_ref - best_col
    read_begin = end_read - best_row
    return ref_begin, read_begin


def banded_sw_traceback(ref: np.ndarray, query: np.ndarray, score: int,
                        gap_open: int, gap_ext: int, band_width: int,
                        mat: np.ndarray) -> List[int]:
    """Banded DP + traceback over the clipped alignment window.

    ``ref`` and ``query`` are the slices [begin..end] from the score/begin
    passes.  Returns the packed CIGAR (length<<4 | op), already in
    read order (banded_sw, ssw.c:577-773).

    Direction codes in the reference: 1=diag, 2=E-extend, 3=E-open,
    4=F-extend, 5=F-open, where E consumes the READ (op I) and F consumes
    the REF (op D).
    """
    refLen = len(ref)
    readLen = len(query)
    NEG = -10**9

    while True:
        # dense [readLen, refLen] tables restricted to the band
        h = np.full((readLen + 1, refLen + 1), 0, dtype=np.int64)
        e = np.full((readLen + 1, refLen + 1), NEG, dtype=np.int64)
        dirs = np.zeros((readLen, refLen, 3), dtype=np.int8)  # de, df, dh
        mx = 0
        for i in range(readLen):
            beg = max(0, i - band_width)
            end = min(refLen - 1, i + band_width)
            f = 0
            # reference resets h_b[0], e_b[0] and the band-edge cell to 0
            # each row (ssw.c:635); the dense tables get the same effect by
            # treating out-of-band cells as 0/NEG via the band bounds and
            # the edge reset below.
            for j in range(beg, end + 1):
                # e: gap in ref (read consumed) from row above
                if i == 0:
                    t1, t2 = -gap_open, -gap_ext
                else:
                    t1 = h[i, j + 1] - gap_open
                    t2 = e[i, j + 1] - gap_ext
                ecur = max(t1, t2)
                de = 3 if t1 > t2 else 2
                # f: gap in read (ref consumed) from left in same row
                t1 = h[i + 1, j] - gap_open
                t2 = f - gap_ext
                fcur = max(t1, t2)
                df = 5 if t1 > t2 else 4
                f = fcur
                e1 = max(ecur, 0)
                f1 = max(fcur, 0)
                t1 = max(e1, f1)
                t2 = h[i, j] + mat[ref[j], query[i]]
                hcur = max(t1, t2)
                if hcur > mx:
                    mx = hcur
                if t1 <= t2:
                    dh = 1
                else:
                    dh = de if e1 > f1 else df
                h[i + 1, j + 1] = hcur
                e[i + 1, j + 1] = ecur
                dirs[i, j] = (de, df, dh)
            # No explicit band-edge reset is needed in the dense form:
            # out-of-band cells are never written, so they stay at their
            # 0 (h) / NEG (e) initialization -- the dense equivalent of
            # the reference's per-row zeroing of its reused band arrays
            # (ssw.c:635).  (An earlier reset here was off by one and
            # clobbered the last IN-band cell, flipping tie-broken
            # paths -- caught by tests/test_refssw.py.)
        if mx >= score:
            break
        band_width *= 2
        if band_width > refLen + readLen:
            # safety: cannot reproduce score; give up with full band
            band_width = refLen + readLen

    # traceback from (readLen-1, refLen-1) following the h-table direction
    # (ssw.c:673-728)
    i = readLen - 1
    j = refLen - 1
    ops: List[Tuple[int, int]] = []   # (count, op) runs, reversed
    cur_op = 0
    cur_n = 0
    table = 2   # 0=e, 1=f, 2=h
    f_op = 0
    while i > 0:
        d = dirs[i, j, table]
        if d == 1:
            i -= 1
            j -= 1
            table = 2
            f_op = 0   # M
        elif d == 2:
            i -= 1
            table = 0
            f_op = 1   # I
        elif d == 3:
            i -= 1
            table = 2
            f_op = 1
        elif d == 4:
            j -= 1
            table = 1
            f_op = 2   # D
        elif d == 5:
            j -= 1
            table = 2
            f_op = 2
        else:
            raise RuntimeError("trace back error")
        if f_op == cur_op:
            cur_n += 1
        else:
            ops.append((cur_n, cur_op))
            cur_op = f_op
            cur_n = 1
    if cur_op == 0:
        ops.append((cur_n + 1, 0))
    else:
        ops.append((cur_n, cur_op))
        ops.append((1, 0))
    # drop the initial empty run, reverse to read order, pack
    runs = [(n, op) for (n, op) in ops if n > 0]
    runs.reverse()
    return [(n << 4) | op for (n, op) in runs]


def align_full(query: np.ndarray, ref: np.ndarray, mat: np.ndarray,
               gap_open: int, gap_ext: int, minimal_score: int
               ) -> Optional[dict]:
    """Full ssw_align equivalent with flag=2/filters=minimal_score
    (ssw.c:834-941 + alignment.cpp:363-399 usage).

    Returns None if no positive score; otherwise a dict with score1 and,
    when score1 >= minimal_score, begin/end coordinates and CIGAR.
    """
    score, end_ref, end_read = sw_score(query, ref, mat, gap_open, gap_ext)
    out = {"score1": score, "ref_end1": end_ref, "read_end1": end_read,
           "ref_begin1": -1, "read_begin1": -1, "cigar": None}
    if score < minimal_score or end_ref < 0:
        return out
    ref_begin, read_begin = sw_begin(query, ref, mat, gap_open, gap_ext,
                                     score, end_ref, end_read)
    out["ref_begin1"] = ref_begin
    out["read_begin1"] = read_begin
    refLen = end_ref - ref_begin + 1
    readLen = end_read - read_begin + 1
    band_width = abs(refLen - readLen) + 1
    out["cigar"] = banded_sw_traceback(
        ref[ref_begin:end_ref + 1], query[read_begin:end_read + 1],
        score, gap_open, gap_ext, band_width, mat)
    return out
