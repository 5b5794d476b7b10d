"""The reference's own Gumbel lambda and K for gapped local alignment.

sortmerna hands its scoring and the database's composition to the ALP
library (refstats.cpp:184-233), whose importance sampling no plain code
reproduces.  The reference estimates the same two numbers the plain
way: the optimal local scores of many pairs of random sequences, drawn
at the database's composition, are fitted by maximum likelihood to the
lattice Karlin-Altschul law P(S >= x) = 1 - exp(-K m n exp(-lambda x)).

ALP charges a gap of length k gap_open + k * gap_ext, one extension more
than the alignments' own gap_open + (k - 1) * gap_ext, so the pairs are
scored with ALP's gap cost: the statistics sortmerna asks for.
"""

from __future__ import annotations

import json
import math
import os
from typing import Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from . import sw


def fit(scores: np.ndarray, m: int, n: int) -> Tuple[float, float]:
    """(lambda, K) of integer maxima of m x n comparisons: the maximum
    likelihood of P(S = x) = F(x + 1) - F(x), F(x) = exp(-C e^(-lambda
    x)), C = K m n, started from the moments' continuous fit."""
    xs, cnt = np.unique(np.asarray(scores, np.float64), return_counts=True)

    def nll(p):
        lam, lc = p
        hi = np.exp(-np.exp(lc - lam * (xs + 1)))
        lo = np.exp(-np.exp(lc - lam * xs))
        return -(cnt * np.log(np.maximum(hi - lo, 1e-300))).sum()

    s = np.asarray(scores, np.float64)
    beta = s.std() * math.sqrt(6) / math.pi
    mu = s.mean() - 0.5772156649 * beta
    r = minimize(nll, [1 / beta, mu / beta], method="Nelder-Mead",
                 options=dict(xatol=1e-9, fatol=1e-10, maxiter=8000))
    lam, lc = r.x
    return float(lam), float(math.exp(lc) / (m * n))


def estimate(freqs: np.ndarray, scoring: dict, pairs: int, length: int,
             seed: int, device="cpu") -> Tuple[float, float]:
    """Fit ``pairs`` optimal scores of two random ``length``-long
    sequences, each drawn from ``freqs`` with numpy's generator at
    ``seed`` (the same pairs on any device)."""
    rng = np.random.default_rng(int(seed))
    p = np.asarray(freqs, np.float64) / np.sum(freqs)
    table = torch.as_tensor(sw.score_table(scoring["match"],
                                           scoring["mismatch"]),
                            device=device)
    rows = max(1, (1 << 27) // length)
    qlen = torch.full((rows,), length, dtype=torch.int64, device=device)
    out = []
    for at in range(0, pairs, rows):
        b = min(rows, pairs - at)
        Q, R = (torch.as_tensor(rng.choice(4, size=(b, length), p=p),
                                device=device) for _ in range(2))
        out.append(sw._block(Q, R, qlen[:b], table,
                             scoring["gap_open"] + scoring["gap_ext"],
                             scoring["gap_ext"]).cpu().numpy())
    return fit(np.concatenate(out), length, length)


def cached(path: str, freqs: np.ndarray, scoring: dict, spec: dict,
           device="cpu") -> Tuple[float, float]:
    """``estimate`` under ``spec`` (pairs, length, seed), kept in the
    JSON file ``path`` with everything it was made from, and made again
    where any of that differs."""
    key = dict(freqs=[round(float(f), 9) for f in freqs],
               scoring=scoring, spec=spec)
    if os.path.exists(path):
        with open(path) as f:
            got = json.load(f)
        if got.get("key") == key:
            return got["lambda"], got["K"]
    lam, K = estimate(freqs, scoring, spec["pairs"], spec["length"],
                      spec["seed"], device)
    with open(path, "w") as f:
        json.dump(dict(key=key, **{"lambda": lam, "K": K}), f)
    return lam, K
