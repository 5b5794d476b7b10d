"""Per-database alignment statistics: Gumbel params, minimal score,
E-values and bitscores.

Port of Refstats (refstats.cpp:103-277) minus the trie geometry (lnwin and
partialwin are fixed by constants.py).  The length-corrected search-space
sizes and the minimal SW score reproduce refstats.cpp:239-265 exactly:

    H        = -sum f log2 f                  (Shannon entropy, log base 2)
    expect_L = floor( ln(K * m * n) / H )
    m'       = m - expect_L * numseq     (if m > expect_L * numseq)
    n'       = n - expect_L * num_reads
    minimal_score = floor( ln(E / (K m' n')) / -lambda )

Bitscore and E-value formulas are those of report_blast.cpp:117-125.

lambda/K provenance (priority order):
  1. explicit ``gumbel_override`` (used by parity tests with values from
     the reference's ALP library),
  2. our own deterministic estimator (stats/gumbel.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..index.builder import BuiltIndex
from .gumbel import island_gumbel


@dataclass
class Refstats:
    num_index_parts: List[int]
    full_ref: List[int]           # corrected reference lengths (m')
    full_read: List[int]          # corrected total read length (n')
    lnwin: List[int]
    partialwin: List[int]
    minimal_score: List[int]
    gumbel: List[Tuple[float, float]]   # (lambda, K) per database
    numseq: List[int]

    def bitscore(self, index_num: int, score1: int) -> int:
        lam, K = self.gumbel[index_num]
        return int(
            np.float32(lam * score1 - math.log(K)) / np.float32(math.log(2)))

    def evalue(self, index_num: int, score1: int) -> float:
        lam, K = self.gumbel[index_num]
        return (K * self.full_ref[index_num] * self.full_read[index_num]
                * math.exp(-lam * score1))


def compute_refstats(
    indexes: Sequence[BuiltIndex],
    all_reads_count: int,
    all_reads_len: int,
    evalue: float,
    match: int = 2,
    mismatch: int = -3,
    gap_open: int = 5,
    gap_ext: int = 2,
    gumbel_override: Optional[List[Tuple[float, float]]] = None,
    cache_dir: Optional[str] = None,
) -> Refstats:
    n_idx = len(indexes)
    rs = Refstats(
        num_index_parts=[len(ix.parts) for ix in indexes],
        full_ref=[ix.stats.full_len for ix in indexes],
        full_read=[all_reads_len] * n_idx,
        lnwin=[ix.stats.seed_win_len for ix in indexes],
        partialwin=[ix.stats.seed_win_len // 2 for ix in indexes],
        minimal_score=[0] * n_idx,
        gumbel=[(0.0, 0.0)] * n_idx,
        numseq=[ix.stats.numseq for ix in indexes],
    )
    for i, ix in enumerate(indexes):
        freqs = ix.stats.background_freq
        if gumbel_override is not None and gumbel_override[i] is not None:
            lam, K = gumbel_override[i]
        else:
            lam, K = _cached_gumbel(match, mismatch, gap_open, gap_ext,
                                    freqs, cache_dir)
        rs.gumbel[i] = (lam, K)

        # Shannon entropy of the background (refstats.cpp:239-243)
        f = np.asarray(freqs, dtype=np.float64)
        entropy = float(-(f * np.log2(f)).sum())

        # length correction (refstats.cpp:245-257)
        expect_l = int(math.log(K * rs.full_ref[i] * rs.full_read[i])
                       / entropy)
        if rs.full_ref[i] > expect_l * rs.numseq[i]:
            rs.full_ref[i] -= expect_l * rs.numseq[i]
        rs.full_read[i] -= expect_l * all_reads_count

        # minimal score S = ln(E/Kmn)/-lambda (refstats.cpp:259-265)
        rs.minimal_score[i] = int(
            math.log(evalue / (K * rs.full_ref[i] * rs.full_read[i]))
            / -lam)
    return rs


def _cached_gumbel(match, mismatch, gap_open, gap_ext, freqs, cache_dir):
    """Disk-cached (lambda, K), keyed by scoring + rounded freqs.

    Provider order: exact ALP driver (stats/alp_exact.py, byte-identical
    to the reference's refstats.cpp:184-233 call) when an ALP source
    tree is available on this machine, else the deterministic estimator
    (stats/gumbel.py)."""
    import json
    import os
    key = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        f = np.asarray(freqs, dtype=np.float64)
        key = "gumbel_%d_%d_%d_%d_%s.json" % (
            match, mismatch, gap_open, gap_ext,
            "_".join(f"{x:.6f}" for x in f))
    from .alp_exact import alp_gumbel_exact, available as alp_available
    if key is not None:
        path = os.path.join(cache_dir, key)
        if os.path.exists(path):
            with open(path) as fh:
                d = json.load(fh)
            # an estimator-cached value must not mask a newly available
            # exact provider
            if d.get("provider") == "alp" or not alp_available():
                return d["lambda"], d["K"]
    got = alp_gumbel_exact(match, mismatch, gap_open, gap_ext, freqs)
    if got is not None:
        lam, K = got
        provider = "alp"
    else:
        from .gumbel import estimate_gumbel
        lam, K = estimate_gumbel(match, mismatch, gap_open, gap_ext, freqs)
        provider = "estimator"
    if key is not None:
        with open(os.path.join(cache_dir, key), "w") as fh:
            json.dump({"lambda": lam, "K": K, "provider": provider}, fh)
    return lam, K


def default_skiplengths(lnwin: int) -> List[int]:
    """{lnwin, lnwin/2, 3} (refstats.cpp:159-166)."""
    return [lnwin, lnwin // 2, 3]
