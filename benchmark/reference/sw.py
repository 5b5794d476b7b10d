"""Plain Smith-Waterman with affine gaps, in PyTorch, batched.

The local alignment score of each query against its whole reference
(no window, no band): H[i, j] = max(0, H[i-1, j-1] + s(q_i, r_j),
E[i, j], F[i, j]); a gap of length L costs gap_open + (L - 1) * gap_ext.
The gap along the reference row is a running maximum: since gap_open >=
gap_ext, F[i, j] = max_{k<j} Hpre[i, k] - gap_open - (j - 1 - k) *
gap_ext, where Hpre is H before F.  Rows are the query, one step each;
columns and the batch are vectorised.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

PAD = 4                 # code of padding: scores BLOCKED against anything
BLOCKED = -(1 << 20)
NEG = -(1 << 28)


def score_table(match: int, mismatch: int) -> np.ndarray:
    t = np.full((5, 5), mismatch, np.int64)
    np.fill_diagonal(t, match)
    t[PAD, :] = BLOCKED
    t[:, PAD] = BLOCKED
    return t


def _pad(seqs: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(seqs), width), PAD, np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def best_scores(queries: List[np.ndarray], refs: List[np.ndarray],
                match: int, mismatch: int, gap_open: int, gap_ext: int,
                device="cpu", block_cells: int = 1 << 27) -> np.ndarray:
    """The optimal local score of each query against its reference.
    Pairs are sorted by query length and run in blocks of about
    ``block_cells`` cells of one row."""
    n = len(queries)
    out = np.zeros(n, np.int64)
    if n == 0:
        return out
    table = torch.as_tensor(score_table(match, mismatch), device=device)
    order = np.argsort([len(q) for q in queries], kind="stable")
    at = 0
    while at < n:
        width = max(len(refs[order[k]]) for k in
                    range(at, min(n, at + 64)))
        rows = max(1, block_cells // max(width, 1))
        sel = order[at:at + rows]
        at += len(sel)
        lr = max(len(refs[k]) for k in sel)
        lq = max(len(queries[k]) for k in sel)
        Q = torch.as_tensor(_pad([queries[k] for k in sel], lq),
                            device=device)
        R = torch.as_tensor(_pad([refs[k] for k in sel], lr), device=device)
        qlen = torch.as_tensor([len(queries[k]) for k in sel],
                               device=device)
        out[sel] = _block(Q, R, qlen, table, gap_open,
                          gap_ext).cpu().numpy()
    return out


def _block(Q, R, qlen, table, go, ge):
    B, lr = R.shape
    dev = R.device
    ramp = torch.arange(lr, device=dev, dtype=torch.int64) * ge
    Hprev = torch.zeros(B, lr, dtype=torch.int64, device=dev)
    E = torch.full((B, lr), NEG, dtype=torch.int64, device=dev)
    best = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)

    for i in range(Q.shape[1]):
        s = table[Q[:, i:i + 1], R]                       # [B, lr]
        diag = torch.cat([torch.zeros(B, 1, dtype=torch.int64, device=dev),
                          Hprev[:, :-1]], 1) + s
        E = torch.maximum(E - ge, Hprev - go)
        Hpre = torch.maximum(torch.maximum(diag, E), zero)
        run = torch.cummax(Hpre + ramp, 1).values
        F = torch.cat([torch.full((B, 1), NEG, dtype=torch.int64,
                                  device=dev),
                       run[:, :-1] - go - ramp[:-1]], 1)
        H = torch.maximum(Hpre, F)
        live = i < qlen
        best = torch.where(live, torch.maximum(best, H.max(1).values), best)
        Hprev = H
    return best
