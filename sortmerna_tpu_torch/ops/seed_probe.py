"""Window seed search by bounded hash probing (host/numpy backend).

Replaces the burst-trie traversal (paralleltraversal.cpp:114-250 +
traverse_bursttrie.cpp) with an *enumerate-and-probe* scheme over the dense
index tables: for each 18-char read window w = w1.w2 (9+9 chars), the set
of reference tails accepted by the d=1 automaton is enumerated in closed
form (see seed_math.py) and membership-tested against hash tables:

subsearch 1a (exact w1, other half within d<=1; paralleltraversal.cpp:163-185)
  * zero     : 18-mer (w1.w2) exact                -> 1 probe, F-exact
  * sub      : 18-mer (w1.V), hamming(V,w2)<=1     -> 37 probes, F-exact
  * del      : 17-mer (w1.D8), D8 = del1(w2)       -> 9 probes,  F-prefix
  * ins      : 19-mer (w1.V9.w2[8])                -> 36 probes, 19-mer
subsearch 1b (exact w2; paralleltraversal.cpp:217-238) -- only when 1a
found no 0-error match:
  * zero     : R-group (w1.w2)                     -> 1 probe, R-exact
               (selects the group's first-inserted representative,
                traverse_bursttrie.cpp:237-262)
  * sub/del/ins symmetric via reversed w1 as the pattern.

Per-window semantics reproduced:
  * 9-mer occurrence gate count > minoccur (paralleltraversal.cpp:161,215)
  * 0-error short-circuit clears all other hits unless --full_search
  * per-window id de-duplication (traverse_bursttrie.cpp:264-277)

The same probe-key construction runs on the device (ops/seed_search.py) --
this module is the reference backend and feeds the engine until the JAX
path takes over the hot loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..index.builder import IndexPart
from ..index.hashtab import lookup_u64

def rev_pack(p: np.ndarray, width: int) -> np.ndarray:
    """Reverse the ``width`` 2-bit chars of a packed value."""
    out = np.zeros_like(p)
    x = p.copy()
    for _ in range(width):
        out = (out << 2) | (x & 3)
        x >>= 2
    return out


def rev9(p: np.ndarray) -> np.ndarray:
    """Reverse the 9 chars of an 18-bit packed value (pw=9 shorthand)."""
    return rev_pack(np.asarray(p, np.int64), 9)


def sub_variants_vec(p: np.ndarray, pw: int = 9) -> np.ndarray:
    """[nw, 4*pw+1] packed sub-neighborhood (original + single swaps)."""
    nw = p.shape[0]
    out = np.empty((nw, 4 * pw + 1), dtype=np.int64)
    out[:, 0] = p
    col = 1
    for i in range(pw):
        shift = 2 * (pw - 1 - i)
        cleared = p & ~(3 << shift)
        for c in range(4):
            out[:, col] = cleared | (c << shift)
            col += 1
    return out


def del_variants_vec(p: np.ndarray, pw: int = 9) -> np.ndarray:
    """[nw, pw] packed (pw-1)-char deletions of a pw-char pattern."""
    nw = p.shape[0]
    out = np.empty((nw, pw), dtype=np.int64)
    for k in range(pw):
        hi = p >> (2 * (pw - k))
        lo = p & ((1 << (2 * (pw - 1 - k))) - 1)
        out[:, k] = (hi << (2 * (pw - 1 - k))) | lo
    return out


def ins9_variants_vec(p: np.ndarray, pw: int = 9) -> np.ndarray:
    """[nw, 4*pw] first-pw-chars of single-insertions of a pw-char
    pattern."""
    nw = p.shape[0]
    out = np.empty((nw, 4 * pw), dtype=np.int64)
    col = 0
    for k in range(pw):
        hi = p >> (2 * (pw - k))
        mid = (p >> 2) & ((1 << (2 * (pw - 1 - k))) - 1)
        for c in range(4):
            out[:, col] = (((hi << 2) | c) << (2 * (pw - 1 - k))) | mid
            col += 1
    return out


def probe_table_bufs(part):
    """The 20 probe-table buffers in native slot order (driver.cpp Buf
    enum / probe_windows argument order), cached on the part.  The
    SINGLE source of truth for that order -- both SeedSearcher and the
    native part driver consume this list, so a table change cannot
    desynchronize them."""
    cached = getattr(part, "_drv_bufs", None)
    if cached is None:
        f_ti, r_ti = fused_scan_tables(part)
        cached = [np.ascontiguousarray(a) for a in (
            part.f_exact_keys, part.f_exact_vals,
            part.f_pref_keys, part.f_pref_start, part.f_pref_count,
            part.r_exact_keys, part.r_exact_start, part.r_exact_count,
            part.r_exact_zero,
            part.r_pref_keys, part.r_pref_start, part.r_pref_count,
            part.k19_keys, part.k19_vals,
            part.r_ids, part.kmer_counts,
            part.f19_offsets, f_ti,
            part.r19_offsets, r_ti)]
        part._drv_bufs = cached
    return cached


def fused_scan_tables(part):
    """Interleaved (tail << 32 | id) uint64 bucket payloads for the
    native probe kernel, cached on the part.  One bucket entry then
    touches one cache-line stream instead of two (the scan is
    memory-latency bound)."""
    cached = getattr(part, "_fused_ti", None)
    if cached is None:
        f_ti = ((part.f19_tails.astype(np.uint64) << np.uint64(32))
                | part.f19_ids.astype(np.uint64))
        r_ti = ((part.r19_tails.astype(np.uint64) << np.uint64(32))
                | part.r19_ids.astype(np.uint64))
        cached = (np.ascontiguousarray(f_ti), np.ascontiguousarray(r_ti))
        part._fused_ti = cached
    return cached


class SeedSearcher:
    """Probes one IndexPart for batches of read windows.

    Dispatches to the native C++ probe kernel when available; the numpy
    path below is the reference backend (tests assert equality)."""

    def __init__(self, part: IndexPart, minoccur: int = 0,
                 full_search: bool = False, use_native: bool = True,
                 threads: int = 1):
        self.part = part
        self.pw = getattr(part, "seed_win_len", 18) // 2
        self.minoccur = minoccur
        self.full_search = full_search
        self.threads = max(1, threads)
        self._lib = None
        if use_native and 4 <= self.pw <= 13:
            # the native kernel instantiates every even L in 8..26
            from .. import native
            self._lib = native.get_lib()
            if self._lib is not None:
                self._cbufs = probe_table_bufs(part)

    def search_windows(self, w1: np.ndarray, w2: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        if self._lib is not None:
            return self._search_native(w1, w2)
        return self._search_numpy(w1, w2)

    def _search_native(self, w1, w2):
        (fxk, fxv, fpk, fps, fpc, rxk, rxs, rxc, rxz, rpk, rps, rpc,
         k19k, k19v, rids, cnts,
         f19o, f19ti, r19o, r19ti) = self._cbufs
        w1 = np.ascontiguousarray(w1, np.int64)
        w2 = np.ascontiguousarray(w2, np.int64)
        nw = len(w1)
        cap = max(4 * nw, 1024)
        while True:
            out_win = np.zeros(cap, np.int64)
            out_id = np.zeros(cap, np.int64)
            n = self._lib.probe_windows(
                fxk.ctypes.data, fxv.ctypes.data, len(fxk),
                fpk.ctypes.data, fps.ctypes.data, fpc.ctypes.data,
                len(fpk),
                rxk.ctypes.data, rxs.ctypes.data, rxc.ctypes.data,
                rxz.ctypes.data, len(rxk),
                rpk.ctypes.data, rps.ctypes.data, rpc.ctypes.data,
                len(rpk),
                k19k.ctypes.data, k19v.ctypes.data, len(k19k),
                rids.ctypes.data, cnts.ctypes.data,
                f19o.ctypes.data, f19ti.ctypes.data,
                r19o.ctypes.data, r19ti.ctypes.data,
                w1.ctypes.data, w2.ctypes.data, nw,
                self.minoccur, int(self.full_search),
                out_win.ctypes.data, out_id.ctypes.data, cap,
                self.threads, self.pw)
            if n >= 0:
                return out_win[:n], out_id[:n]
            if n == -(2 ** 63):
                # probe.cpp's unsupported-pw sentinel, not a capacity
                # hint (pw is validated to 4..13 upstream; belt and
                # braces against a stale .so)
                raise ValueError(
                    f"native probe_windows: unsupported seed half-width"
                    f" pw={self.pw} (supported 4..13)")
            cap = int(-n) + 16

    def _search_numpy(self, w1: np.ndarray, w2: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Search a batch of windows.

        w1, w2: int64[nw] packed 9-mer halves (MSB-first).
        Returns (hit_win, hit_id): parallel arrays of per-window unique
        reference-kmer ids (the id_win pairs of paralleltraversal.cpp:241).
        """
        part = self.part
        pw = self.pw
        h = 2 * pw               # bits per half
        n_sub = 4 * pw + 1
        n_del = pw
        n_ins = 4 * pw
        nw = w1.shape[0]
        counts = part.kmer_counts

        gate_f = counts[w1] > self.minoccur
        gate_r = counts[w2] > self.minoccur

        # ---------- subsearch 1a ----------
        k18_exact = (w1 << h) | w2
        zf, zid = lookup_u64(part.f_exact_keys, part.f_exact_vals,
                             k18_exact.astype(np.uint64))
        zero_a = zf & gate_f

        # sub probes -- include the exact one again; harmless under set
        # semantics.
        subs = sub_variants_vec(w2, pw)
        sub_keys = ((w1[:, None] << h) | subs).astype(np.uint64)
        sf, sid = lookup_u64(part.f_exact_keys, part.f_exact_vals,
                             sub_keys.ravel())
        sf = sf.reshape(nw, n_sub) & gate_f[:, None]
        sid = sid.reshape(nw, n_sub)

        # del probes -> contiguous id ranges
        dels = del_variants_vec(w2, pw)
        del_keys = ((w1[:, None] << (h - 2)) | dels).astype(np.uint64)
        df, dval = lookup_u64(part.f_pref_keys,
                              np.stack([part.f_pref_start,
                                        part.f_pref_count], axis=1),
                              del_keys.ravel())
        df = df.reshape(nw, n_del) & gate_f[:, None]
        dstart = dval[:, 0].reshape(nw, n_del)
        dcount = np.where(df, dval[:, 1].reshape(nw, n_del), 0)

        # ins probes -> single ids via (L+1)-mer table
        ins9 = ins9_variants_vec(w2, pw)
        p8 = w2 & 3   # last char of the pattern w2
        ins_keys = ((w1[:, None].astype(np.uint64) << np.uint64(h + 2))
                    | (ins9.astype(np.uint64) << np.uint64(2))
                    | p8[:, None].astype(np.uint64))
        inf, inid = lookup_u64(part.k19_keys, part.k19_vals, ins_keys.ravel())
        inf = inf.reshape(nw, n_ins) & gate_f[:, None]
        inid = inid.reshape(nw, n_ins)

        # ---------- subsearch 1b ----------
        p_r = rev_pack(w1, pw)
        rkey_exact = ((w1 << h) | w2).astype(np.uint64)  # pack(c1..c18)
        rzf, rzval = lookup_u64(
            part.r_exact_keys,
            np.stack([part.r_exact_start, part.r_exact_count,
                      part.r_exact_zero], axis=1),
            rkey_exact)
        zero_b = rzf & gate_r

        rsubs = sub_variants_vec(p_r, pw)
        rsub_keys = ((rev_pack(rsubs.reshape(-1), pw).reshape(nw, n_sub)
                      << h) | w2[:, None]).astype(np.uint64)
        rsf, rsval = lookup_u64(
            part.r_exact_keys,
            np.stack([part.r_exact_start, part.r_exact_count], axis=1),
            rsub_keys.ravel())
        rsf = rsf.reshape(nw, n_sub) & gate_r[:, None]
        rs_start = rsval[:, 0].reshape(nw, n_sub)
        rs_count = np.where(rsf, rsval[:, 1].reshape(nw, n_sub), 0)

        rdels = del_variants_vec(p_r, pw)
        rdel_keys = ((rev_pack(rdels.reshape(-1), pw - 1).reshape(
                        nw, n_del) << h)
                     | w2[:, None]).astype(np.uint64)
        rdf, rdval = lookup_u64(
            part.r_pref_keys,
            np.stack([part.r_pref_start, part.r_pref_count], axis=1),
            rdel_keys.ravel())
        rdf = rdf.reshape(nw, n_del) & gate_r[:, None]
        rd_start = rdval[:, 0].reshape(nw, n_del)
        rd_count = np.where(rdf, rdval[:, 1].reshape(nw, n_del), 0)

        rins9 = ins9_variants_vec(p_r, pw)
        c0 = w1 >> (h - 2)     # P_r[pw-1] == w1[0] == top char of w1
        rins_keys = ((c0[:, None].astype(np.uint64) << np.uint64(2 * h))
                     | (rev_pack(rins9.reshape(-1), pw).reshape(
                         nw, n_ins).astype(np.uint64) << np.uint64(h))
                     | w2[:, None].astype(np.uint64))
        rinf, rinid = lookup_u64(part.k19_keys, part.k19_vals,
                                 rins_keys.ravel())
        rinf = rinf.reshape(nw, n_ins) & gate_r[:, None]
        rinid = rinid.reshape(nw, n_ins)

        # ---------- combine with 0-error short-circuit semantics ----------
        # fully vectorized; three window modes (paralleltraversal semantics):
        #   A: 1a 0-error -> {exact id}, skip everything else
        #   B: 1b 0-error (no 1a zero) -> {group representative}, discarding
        #      1a's 1-error hits (id_hits.clear, traverse_bursttrie:256-262)
        #   C: union of all 1-error hits from both subsearches
        full = self.full_search
        r_ids = self.part.r_ids.astype(np.int64)
        mode_a = zero_a & (not full)
        mode_b = zero_b & ~mode_a & (not full)
        mode_c = ~(mode_a | mode_b)

        win_parts = []
        id_parts = []

        wa = np.flatnonzero(mode_a)
        win_parts.append(wa)
        id_parts.append(zid[wa].astype(np.int64))
        wb = np.flatnonzero(mode_b)
        win_parts.append(wb)
        id_parts.append(rzval[wb, 2].astype(np.int64))

        cm = mode_c[:, None]
        for found, ids_ in ((sf & cm, sid), (inf & cm, inid),
                            (rinf & cm, rinid)):
            w, c = np.nonzero(found)
            win_parts.append(w)
            id_parts.append(ids_[w, c].astype(np.int64))
        # F-prefix groups expand to contiguous id ranges
        w, c = np.nonzero((dcount > 0) & cm)
        cnt = dcount[w, c].astype(np.int64)
        st_ = dstart[w, c].astype(np.int64)
        win_parts.append(np.repeat(w, cnt))
        id_parts.append(np.repeat(st_, cnt) + _within(cnt))
        # R groups expand through the r_ids array
        for rc, rs in ((rs_count, rs_start), (rd_count, rd_start)):
            w, c = np.nonzero((rc > 0) & cm)
            cnt = rc[w, c].astype(np.int64)
            st_ = rs[w, c].astype(np.int64)
            flat = np.repeat(st_, cnt) + _within(cnt)
            win_parts.append(np.repeat(w, cnt))
            id_parts.append(r_ids[flat])

        win_all = np.concatenate(win_parts)
        id_all = np.concatenate(id_parts)
        # de-dup per window; output sorted by (window, id)
        key = win_all * (1 << 40) + id_all
        uniq = np.unique(key)
        return (uniq >> 40).astype(np.int64), \
            (uniq & ((1 << 40) - 1)).astype(np.int64)


def _within(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
