"""Device backend for the engine's SW waves (PyTorch; CUDA kernels).

Counterpart of the JAX package's ops/sw_jax.JaxSwBackend, with every
method the engine calls: ``batch_coords`` and its asynchronous halves
``batch_coords_submit`` / ``batch_coords_fetch`` (the native part driver's
waves), ``batch_coords_hostgather``, ``batch`` (the python traverse),
the ``_device_call`` hook and ``_traceback_many``.

On ``cuda`` each wave block is one ``sw_fused`` kernel launch
(ops/sw_kernels.py): the block is packed by the native ``sw_fill_block``
straight into a pinned staging tensor, uploaded with ``non_blocking``,
scored, and its ``[5, B]`` result copied back into a pinned host tensor
behind a CUDA event; ``batch_coords_fetch`` waits on the event.  On
``cpu`` the same blocks go through the kernels' plain PyTorch versions.
CIGAR traceback runs on the host (banded, only for accepted alignments)
via the native C++ kernel when available.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import sw_kernels
from .sw_kernels import sw_fused, sw_score_batch


def resolve_device(device=None) -> torch.device:
    """The device the SW waves run on: ``cuda`` unless the caller asks for
    ``cpu``.  Raises when CUDA is asked for (or defaulted to) and absent --
    a run never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sortmerna_tpu_torch: the SW kernels run on 'cuda' (the "
                "default) but torch.cuda.is_available() is False; pass "
                "device='cpu' (SMR_TORCH_DEVICE=cpu for the CLI) to run "
                "their plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _gather_rows_u8(data, off, lens, B, L):
    n_ = len(off)
    pos = np.arange(L, dtype=np.int64)[None, :]
    idx = np.minimum(off[:, None] + pos, len(data) - 1)
    M = data[idx]
    M[pos >= lens[:, None]] = 0
    out = np.zeros((B, L), np.uint8)
    out[:n_] = M
    return out


class TorchSwBackend:
    """SW waves on a torch device: scoring + begin-coordinate passes in
    padded shape buckets on ``device`` (default ``cuda``), CIGAR
    traceback on the host."""

    def __init__(self, mat: np.ndarray, gap_open: int, gap_ext: int,
                 device=None, use_native: bool = True):
        self.device = resolve_device(device)
        self.mat_np = np.asarray(mat, dtype=np.int64)
        self.mat = torch.as_tensor(np.asarray(mat, np.int32)).to(
            self.device).contiguous()
        self.gap_open = int(gap_open)
        self.gap_ext = int(gap_ext)
        self.native = None
        if use_native:
            from .. import native
            if native.have_native():
                self.native = native
        if self.device.type == "cuda":
            sw_kernels.load()           # build now: fail before any wave

    def _device_call(self, buf: torch.Tensor, B: int, lq: int, lr: int):
        """One fused SW launch on a block already on ``self.device``;
        returns the int32 [5, B] result there."""
        return sw_fused(buf, self.mat, B, lq, lr, self.gap_open,
                        self.gap_ext)

    def _traceback_many(self, refs, queries, scores, bands):
        if self.native is not None:
            return self.native.traceback_batch(
                refs, queries, scores, bands, self.gap_open, self.gap_ext,
                self.mat_np)
        from . import sw_ref
        return [sw_ref.banded_sw_traceback(
                    r, q, s, self.gap_open, self.gap_ext, b, self.mat_np)
                for r, q, s, b in zip(refs, queries, scores, bands)]

    # Shape discipline: sequence lengths snap to a coarse geometric ladder
    # (floor 256) and the batch dim to a short block ladder, so a wave's
    # jobs sort into few padded shapes.
    _LEN_LADDER = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                   65536)
    # Jobs per block; SMR_SW_BLOCK overrides.
    BLOCK = int(os.environ.get("SMR_SW_BLOCK", "4096"))
    # per-block cell budget rows*(lq+lr): full blocks up to ~1024-char
    # tiles; long-read buckets shrink the row count (30K-nt jobs run 64
    # rows a block).  Scales with BLOCK so the row ladder keeps the same
    # per-length proportions.
    BLOCK_CELLS = BLOCK * 1024

    @classmethod
    def _len_bucket(cls, n: int) -> int:
        for b in cls._LEN_LADDER:
            if n <= b:
                return b
        return cls._LEN_LADDER[-1]

    @classmethod
    def _min_block(cls, n: int) -> int:
        for b in (64, 256, 1024, 4096, cls.BLOCK):
            if n <= b:
                return min(b, cls.BLOCK)   # SMR_SW_BLOCK may be < 4096
        return cls.BLOCK

    @property
    def _pad_full_block(self) -> bool:
        """On the GPU blocks pad to the short block ladder (at least 256
        rows); CPU runs (tests) keep the small-block ladder -- padding is
        pure cost there."""
        return self.device.type == "cuda"

    def batch_coords(self, q_data: np.ndarray, q_off, q_len,
                     r_data: np.ndarray, r_off, r_len, minimal):
        """Coordinate-based scoring via the fused one-upload /
        one-download device call.  Returns (score, rb, re, qb, qe)."""
        return self.batch_coords_fetch(self.batch_coords_submit(
            q_data, q_off, q_len, r_data, r_off, r_len, minimal))

    def batch_coords_submit(self, q_data: np.ndarray, q_off, q_len,
                            r_data: np.ndarray, r_off, r_len, minimal):
        """Asynchronous half of batch_coords: launches every block's
        kernel (and its device->host copy) without blocking, so a caller
        can run host work for OTHER reads while the device computes.
        Returns an opaque wave handle for batch_coords_fetch; the handle
        holds every staging buffer until the fetch."""
        q_data = np.asarray(q_data, np.uint8)
        r_data = np.asarray(r_data, np.uint8)
        q_off = np.asarray(q_off, np.int64)
        q_len = np.asarray(q_len, np.int32)
        r_off = np.asarray(r_off, np.int64)
        r_len = np.asarray(r_len, np.int32)
        minimal = np.asarray(minimal, np.int32)
        n = len(q_off)
        score = np.zeros(n, np.int32)
        end_ref = np.full(n, -1, np.int32)
        end_read = np.zeros(n, np.int32)
        beg_ref = np.full(n, -1, np.int32)
        beg_read = np.full(n, -1, np.int32)
        cuda = self.device.type == "cuda"

        # One launch per block of jobs.  Jobs sort by size so each
        # block's padded shape tracks its own max; blocks are launched
        # asynchronously and downloaded after all are in flight.
        order = np.lexsort((q_len, r_len))[::-1] if n else \
            np.zeros(0, np.int64)
        pending = []
        from ..util import timed
        b0 = 0
        while b0 < n:
            tent = order[b0:b0 + self.BLOCK]
            lq = self._len_bucket(int(q_len[tent].max()))
            lr = self._len_bucket(int(r_len[tent].max()))
            # long jobs (30K-nt reads) shrink the row count so one
            # block's device working set stays bounded; jobs are sorted
            # by size, so long jobs cluster in their own blocks and the
            # short-read path (lq+lr <= 1024) keeps the full BLOCK
            rows = self.BLOCK
            while rows > 64 and rows * (lq + lr) > self.BLOCK_CELLS:
                rows //= 4
            ba = tent[:rows]
            b0 += len(ba)
            if len(ba) < len(tent):
                lq = self._len_bucket(int(q_len[ba].max()))
                lr = self._len_bucket(int(r_len[ba].max()))
            if self._pad_full_block:
                # pad to a SHORT block ladder (256/1024/4096) instead of
                # always the full block: late small waves (pass 2/3,
                # strand 2) then do not pay for a whole 4096-row tile
                B = max(self._min_block(len(ba)), 256)
                B = min(B, rows)           # long-read cell-budget cap
            else:
                # the plain version computes every row it is given, and
                # there are no compiled shapes to reuse: no padding
                B = len(ba)
            hq, hr = lq // 2, lr // 2
            if cuda:
                stage = torch.empty((B, hq + hr + 12), dtype=torch.uint8,
                                    pin_memory=True)
                buf = stage.numpy()
            else:
                stage = None
                buf = np.empty((B, hq + hr + 12), np.uint8)
            if self.native is not None:
                # one C++ pass: gather + 4-bit pack + scalar tail.  `sel`
                # MUST stay bound to a local for the duration of the
                # call: .ctypes.data on a temporary yields a pointer into
                # memory CPython frees before the foreign call runs.
                sel = np.ascontiguousarray(ba, np.int64)
                self.native.get_lib().sw_fill_block(
                    q_data.ctypes.data, len(q_data), q_off.ctypes.data,
                    q_len.ctypes.data,
                    r_data.ctypes.data, len(r_data), r_off.ctypes.data,
                    r_len.ctypes.data, minimal.ctypes.data,
                    sel.ctypes.data,
                    len(ba), B, lq, lr, buf.ctypes.data)
                del sel
            else:
                qrows = _gather_rows_u8(
                    q_data, q_off[ba], q_len[ba].astype(np.int64), B, lq)
                rrows = _gather_rows_u8(
                    r_data, r_off[ba], r_len[ba].astype(np.int64), B, lr)
                buf[:, :hq] = (qrows[:, ::2] << 4) | qrows[:, 1::2]
                buf[:, hq:hq + hr] = (rrows[:, ::2] << 4) \
                    | rrows[:, 1::2]
                ints = np.ones((B, 3), np.int32)
                ints[:, 2] = 1 << 30
                ints[:len(ba), 0] = q_len[ba]
                ints[:len(ba), 1] = r_len[ba]
                ints[:len(ba), 2] = minimal[ba]
                buf[:, hq + hr:] = ints.view(np.uint8).reshape(B, 12)
            with timed(f"sw_submit[{B}x{lq}x{lr}]"):
                if cuda:
                    dev_in = stage.to(self.device, non_blocking=True)
                    dev_out = self._device_call(dev_in, B, lq, lr)
                    host = torch.empty((5, B), dtype=torch.int32,
                                       pin_memory=True)
                    host.copy_(dev_out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    res = (done, host, stage, dev_in, dev_out)
                else:
                    res = (None, self._device_call(
                        torch.from_numpy(buf), B, lq, lr))
            pending.append((ba, res))
        return pending, (score, beg_ref, end_ref, beg_read, end_read)

    @staticmethod
    def batch_coords_fetch(handle):
        """Blocking half of batch_coords: waits for the wave's device
        results and scatters them into the job-order output arrays."""
        from ..util import timed
        pending, (score, beg_ref, end_ref, beg_read, end_read) = handle
        with timed("sw_fetch"):
            for ba, res in pending:
                done, out = res[0], res[1]
                if done is not None:
                    done.synchronize()
                out = out.numpy()
                score[ba] = out[0, :len(ba)]
                beg_ref[ba] = out[1, :len(ba)]
                end_ref[ba] = out[2, :len(ba)]
                beg_read[ba] = out[3, :len(ba)]
                end_read[ba] = out[4, :len(ba)]
        return score, beg_ref, end_ref, beg_read, end_read

    def _score(self, Q, ql, R, rl, terminate=False, ts=None):
        """sw_score_batch on numpy blocks; numpy results."""
        t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        out = sw_score_batch(t(Q), t(ql), t(R), t(rl), self.mat,
                             self.gap_open, self.gap_ext,
                             terminate=terminate,
                             tscore=None if ts is None else t(ts))
        return tuple(o.cpu().numpy() for o in out)

    def batch_coords_hostgather(self, q_data: np.ndarray, q_off, q_len,
                                r_data: np.ndarray, r_off, r_len, minimal):
        """Host-gather variant (kept as the fallback/reference path)."""
        n = len(q_off)
        score = np.zeros(n, np.int32)
        end_ref = np.full(n, -1, np.int32)
        end_read = np.zeros(n, np.int32)
        beg_ref = np.full(n, -1, np.int32)
        beg_read = np.full(n, -1, np.int32)
        order = list(range(n))
        # group by length bucket
        groups = {}
        for i in order:
            key = (self._len_bucket(int(q_len[i])),
                   self._len_bucket(int(r_len[i])))
            groups.setdefault(key, []).append(i)
        q_off = np.asarray(q_off, np.int64)
        q_len = np.asarray(q_len, np.int64)
        r_off = np.asarray(r_off, np.int64)
        r_len = np.asarray(r_len, np.int64)

        def gather_rows(data, off, lens, B, L):
            """[B, L] padded gather from a concatenated buffer."""
            n_ = len(off)
            pos = np.arange(L, dtype=np.int64)[None, :]
            idx = np.minimum(off[:, None] + pos, len(data) - 1)
            M = data[idx].astype(np.int32)
            M[pos >= lens[:, None]] = 0
            out = np.zeros((B, L), np.int32)
            out[:n_] = M
            lo = np.ones(B, np.int32)
            lo[:n_] = np.maximum(lens, 1)
            return out, lo

        for (lq, lr), idxs in groups.items():
            ia = np.asarray(idxs, np.int64)
            for b0 in range(0, len(idxs), self.BLOCK):
                bidx = idxs[b0:b0 + self.BLOCK]
                ba = ia[b0:b0 + self.BLOCK]
                B = self.BLOCK if len(idxs) > self.BLOCK else \
                    self._min_block(len(bidx))
                Q, ql = gather_rows(q_data, q_off[ba], q_len[ba], B, lq)
                R, rl = gather_rows(r_data, r_off[ba], r_len[ba], B, lr)
                s, er, eq = self._score(Q, ql, R, rl)
                for k, i in enumerate(bidx):
                    score[i] = s[k]
                    end_ref[i] = er[k]
                    end_read[i] = eq[k]
            # begin pass (reversed prefixes gathered in one shot)
            need = [i for i in idxs
                    if score[i] >= minimal[i] and end_ref[i] >= 0]
            na = np.asarray(need, np.int64)

            def gather_rev(data, off, ends, B, L):
                n_ = len(off)
                pos = np.arange(L, dtype=np.int64)[None, :]
                idx = off[:, None] + ends[:, None] - pos
                valid = pos <= ends[:, None]
                idx = np.clip(idx, 0, len(data) - 1)
                M = data[idx].astype(np.int32)
                M[~valid] = 0
                out = np.zeros((B, L), np.int32)
                out[:n_] = M
                lo = np.ones(B, np.int32)
                lo[:n_] = ends + 1
                return out, lo

            for b0 in range(0, len(need), self.BLOCK):
                bneed = need[b0:b0 + self.BLOCK]
                ba = na[b0:b0 + self.BLOCK]
                B2 = self.BLOCK if len(need) > self.BLOCK else \
                    self._min_block(len(bneed))
                Q2, ql2 = gather_rev(q_data, q_off[ba],
                                     end_read[ba].astype(np.int64), B2, lq)
                R2, rl2 = gather_rev(r_data, r_off[ba],
                                     end_ref[ba].astype(np.int64), B2, lr)
                ts = np.zeros(B2, np.int32)
                ts[:len(bneed)] = score[ba]
                s2, ec2, er2 = self._score(Q2, ql2, R2, rl2,
                                           terminate=True, ts=ts)
                for k2, i in enumerate(bneed):
                    beg_ref[i] = end_ref[i] - ec2[k2]
                    beg_read[i] = end_read[i] - er2[k2]
        return score, beg_ref, end_ref, beg_read, end_read

    def batch(self, jobs):
        if not jobs:
            return []
        results = [None] * len(jobs)
        # group by padded length bucket
        groups = {}
        for i, j in enumerate(jobs):
            key = (self._len_bucket(len(j.query)),
                   self._len_bucket(len(j.ref)))
            groups.setdefault(key, []).append(i)

        for (lq, lr), idxs in groups.items():
            qs = [np.asarray(jobs[i].query, dtype=np.int32) for i in idxs]
            rs = [np.asarray(jobs[i].ref, dtype=np.int32) for i in idxs]
            n = len(idxs)
            score = np.zeros(n, dtype=np.int32)
            end_ref = np.zeros(n, dtype=np.int32)
            end_read = np.zeros(n, dtype=np.int32)
            for b0 in range(0, n, self.BLOCK):
                bidx = range(b0, min(b0 + self.BLOCK, n))
                B = self.BLOCK if n > self.BLOCK else \
                    self._min_block(len(bidx))
                Q = np.zeros((B, lq), dtype=np.int32)
                R = np.zeros((B, lr), dtype=np.int32)
                ql = np.ones(B, dtype=np.int32)
                rl = np.ones(B, dtype=np.int32)
                for k, i in enumerate(bidx):
                    Q[k, :len(qs[i])] = qs[i]
                    R[k, :len(rs[i])] = rs[i]
                    ql[k] = len(qs[i])
                    rl[k] = len(rs[i])
                s, er, eq = self._score(Q, ql, R, rl)
                for k, i in enumerate(bidx):
                    score[i] = s[k]
                    end_ref[i] = er[k]
                    end_read[i] = eq[k]

            # begin pass for jobs meeting the threshold (flag=2 semantics,
            # ssw.c:897)
            need = [k for k in range(n)
                    if score[k] >= jobs[idxs[k]].minimal_score
                    and end_ref[k] >= 0]
            beg_ref = np.full(n, -1, dtype=np.int64)
            beg_read = np.full(n, -1, dtype=np.int64)
            for b0 in range(0, len(need), self.BLOCK):
                bneed = need[b0:b0 + self.BLOCK]
                B2 = self.BLOCK if len(need) > self.BLOCK else \
                    self._min_block(len(bneed))
                Q2 = np.zeros((B2, lq), dtype=np.int32)
                R2 = np.zeros((B2, lr), dtype=np.int32)
                ql2 = np.ones(B2, dtype=np.int32)
                rl2 = np.ones(B2, dtype=np.int32)
                ts = np.zeros(B2, dtype=np.int32)
                for k2, k in enumerate(bneed):
                    rq = qs[k][end_read[k]::-1]
                    rr = rs[k][end_ref[k]::-1]
                    Q2[k2, :len(rq)] = rq
                    R2[k2, :len(rr)] = rr
                    ql2[k2] = len(rq)
                    rl2[k2] = len(rr)
                    ts[k2] = score[k]
                s2, ec2, er2 = self._score(Q2, ql2, R2, rl2,
                                           terminate=True, ts=ts)
                for k2, k in enumerate(bneed):
                    beg_ref[k] = end_ref[k] - ec2[k2]
                    beg_read[k] = end_read[k] - er2[k2]

            tb_refs, tb_qs, tb_scores, tb_bands, tb_at = [], [], [], [], []
            for k, i in enumerate(idxs):
                res = {"score1": int(score[k]),
                       "ref_end1": int(end_ref[k]),
                       "read_end1": int(end_read[k]),
                       "ref_begin1": int(beg_ref[k]),
                       "read_begin1": int(beg_read[k]),
                       "cigar": None}
                if beg_ref[k] >= 0:
                    refw = rs[k][beg_ref[k]:end_ref[k] + 1]
                    qw = qs[k][beg_read[k]:end_read[k] + 1]
                    tb_refs.append(refw.astype(np.uint8))
                    tb_qs.append(qw.astype(np.uint8))
                    tb_scores.append(int(score[k]))
                    tb_bands.append(abs(len(refw) - len(qw)) + 1)
                    tb_at.append(i)
                results[i] = res
            if tb_at:
                cigars = self._traceback_many(tb_refs, tb_qs, tb_scores,
                                              tb_bands)
                for i, cg in zip(tb_at, cigars):
                    results[i]["cigar"] = cg
        return results
