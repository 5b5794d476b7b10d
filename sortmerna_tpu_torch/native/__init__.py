"""Native (C++) host kernels, built on demand with g++ and bound via ctypes.

Currently:
* banded_traceback_batch -- CIGAR generation for accepted alignments
  (traceback.cpp), the host-side partner of the device SW scoring kernel.

The build is cached under <repo>/build/native_torch, as its own library
(libsmrtorch_native.so) so that it never replaces the JAX package's; both
load with RTLD_LOCAL and can live in one process.  If no compiler is
available the callers fall back to the numpy implementations.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..util import tally

_SRC_DIR = pathlib.Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent.parent / "build" / "native_torch"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build() -> Optional[ctypes.CDLL]:
    """The library, built and loaded by the first call (None without a
    compiler); a thread that arrives during another's build waits for
    it rather than taking the numpy paths."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _load()
            _TRIED = True
    return _LIB


def _load() -> Optional[ctypes.CDLL]:
    # Escape hatch: a host-side native bug must never zero a whole run
    # (bench.py's preflight falls back to the numpy paths via this).
    if os.environ.get("SMR_NO_NATIVE") == "1":
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / "libsmrtorch_native.so"
    srcs = [_SRC_DIR / "traceback.cpp", _SRC_DIR / "engine.cpp",
            _SRC_DIR / "probe.cpp", _SRC_DIR / "gumbel.cpp",
            _SRC_DIR / "driver.cpp", _SRC_DIR / "feed_scan.cpp",
            _SRC_DIR / "refload.cpp", _SRC_DIR / "pool.cpp"]
    hdrs = [_SRC_DIR / "engine_core.hpp", _SRC_DIR / "pool.hpp"]
    if (not so.exists()
            or any(so.stat().st_mtime < s.stat().st_mtime
                   for s in srcs + hdrs)):
        # build to a temp name + atomic rename: a concurrent process
        # with the old .so mapped keeps its (old-inode) mapping intact
        # instead of having its text pages rewritten under it
        tmp = so.with_suffix(".so.%d" % os.getpid())
        try:
            extra = os.environ.get("SMR_NATIVE_CXXFLAGS", "").split()
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", "-o", str(tmp)] + extra
                + [str(s) for s in srcs],
                check=True, capture_output=True)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            # a silent fallback to the numpy paths turns a compile typo
            # into a 100x slowdown that looks like a hang -- say why
            import sys
            print("sortmerna_tpu_torch: native build FAILED, using numpy "
                  "fallback:\n" + e.stderr.decode()[-2000:],
                  file=sys.stderr)
            tmp.unlink(missing_ok=True)
            return None
        except Exception:
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so), mode=ctypes.RTLD_LOCAL)
    except OSError:
        return None
    lib.banded_traceback_batch.restype = ctypes.c_int
    lib.banded_traceback_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.banded_traceback_ptrs.restype = ctypes.c_int
    lib.banded_traceback_ptrs.argtypes = \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.cand_create.restype = ctypes.c_void_p
    lib.cand_create.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 7 + [ctypes.c_long] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.cand_destroy.argtypes = [ctypes.c_void_p]
    lib.cand_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cand_start.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32]
    lib.cand_next_jobs.restype = ctypes.c_int32
    lib.cand_next_jobs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.cand_post.argtypes = [ctypes.c_void_p, ctypes.c_int32] + \
        [ctypes.c_void_p] * 5
    lib.cand_num_active.restype = ctypes.c_int32
    lib.cand_num_active.argtypes = [ctypes.c_void_p]
    lib.cand_num_jobs.restype = ctypes.c_int32
    lib.cand_num_jobs.argtypes = [ctypes.c_void_p]
    lib.cand_read_states_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.cand_read_state.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_void_p]
    lib.cand_num_actions.restype = ctypes.c_int32
    lib.cand_num_actions.argtypes = [ctypes.c_void_p]
    lib.cand_export_actions.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.cand_clear_actions.argtypes = [ctypes.c_void_p]
    lib.cand_stat_num_aligned.restype = ctypes.c_int64
    lib.cand_stat_num_aligned.argtypes = [ctypes.c_void_p]
    lib.cand_stat_num_dbs.restype = ctypes.c_int32
    lib.cand_stat_num_dbs.argtypes = [ctypes.c_void_p]
    lib.cand_stat_dbs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.cand_sw_counts.restype = None
    lib.cand_sw_counts.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cand_start_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32] + [ctypes.c_void_p] * 8
    lib.gumbel_island.restype = ctypes.c_int64
    lib.gumbel_island.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
    lib.trav_create.restype = ctypes.c_void_p
    lib.trav_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.trav_destroy.argtypes = [ctypes.c_void_p]
    lib.trav_engine.restype = ctypes.c_void_p
    lib.trav_engine.argtypes = [ctypes.c_void_p]
    lib.trav_strand.restype = ctypes.c_int32
    lib.trav_strand.argtypes = [ctypes.c_void_p]
    lib.trav_pump.restype = ctypes.c_int32
    lib.trav_pump.argtypes = [ctypes.c_void_p]
    lib.trav_pump_many.restype = ctypes.c_int64
    lib.trav_pump_many.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_void_p]
    lib.pool_counts.argtypes = [ctypes.c_void_p]
    lib.pool_run.argtypes = [ctypes.c_int32, ctypes.c_int64,
                             ctypes.c_void_p]
    lib.trav_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cand_set_reads.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cand_set_strand.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.feed_scan_fasta.restype = ctypes.c_int64
    lib.feed_scan_fasta.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32] + \
        [ctypes.c_void_p] * 5
    lib.feed_scan_fastq.restype = ctypes.c_int64
    lib.feed_scan_fastq.argtypes = [
        ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 7
    lib.batch_strands.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
    lib.cigar_stats_batch.argtypes = \
        [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_void_p]
    lib.sw_fill_block.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64]       # q_data, q_data_len
        + [ctypes.c_void_p] * 2                 # q_off, q_len
        + [ctypes.c_void_p, ctypes.c_int64]     # r_data, r_data_len
        + [ctypes.c_void_p] * 3                 # r_off, r_len, minimal
        + [ctypes.c_void_p]                     # sel
        + [ctypes.c_int64] * 4                  # n_sel, B, lq, lr
        + [ctypes.c_void_p])                    # buf
    lib.gather_action_windows.argtypes = \
        [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_void_p] * 4
    lib.reffmt_scan_tries.restype = ctypes.c_int64
    lib.reffmt_scan_tries.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]
    lib.reffmt_scan_pos.restype = ctypes.c_int64
    lib.reffmt_scan_pos.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64]
    lib.probe_windows.restype = ctypes.c_int64
    lib.probe_windows.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]        # fx
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64]                # fp
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64]                # rx
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64]                # rp
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]      # k19
        + [ctypes.c_void_p, ctypes.c_void_p]                      # r_ids, counts
        + [ctypes.c_void_p] * 4                                   # scan tables
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]      # windows
        + [ctypes.c_int32, ctypes.c_int32]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_int32, ctypes.c_int32])                       # threads, pw
    return lib


def get_lib():
    return _build()


def have_native() -> bool:
    return _build() is not None


def tally_sw_counts(engine) -> None:
    """Add a candidate engine's SW job counts to the stage timers' count
    slots: ``sw_jobs_scored``, the jobs the device scored,
    ``sw_jobs_consumed``, the results a read's FSM applied,
    ``sw_fsm_starts``, the FSMs their start left waiting on the device,
    and ``sw_fsm_rounds``, the (FSM, wave) pairs that offered jobs."""
    out = np.zeros(4, np.int64)
    _build().cand_sw_counts(engine, out.ctypes.data)
    tally("sw_jobs_scored", count=int(out[0]))
    tally("sw_jobs_consumed", count=int(out[1]))
    tally("sw_fsm_starts", count=int(out[2]))
    tally("sw_fsm_rounds", count=int(out[3]))


def traceback_batch(refs: List[np.ndarray], queries: List[np.ndarray],
                    scores: List[int], bands: List[int],
                    gap_open: int, gap_ext: int, mat: np.ndarray,
                    cigar_cap: int = 0) -> List[List[int]]:
    """Batched banded traceback; returns a packed CIGAR list per job."""
    lib = _build()
    assert lib is not None
    n = len(refs)
    if cigar_cap <= 0:
        # A banded path emits at most rl+ql ops.  Rows are bucketed by
        # that bound so one MAX_READ_LEN (30K nt) alignment doesn't
        # inflate the whole batch's output matrix to n x 60K ops: each
        # bucket gets its own tight cap and the results re-interleave.
        sizes = [len(r) + len(q) + 8 for r, q in zip(refs, queries)]
        mx = max(sizes) if n else 8
        if mx > 1024 and n > 1:
            buckets = (1024, 8192, mx)
            groups = [[] for _ in buckets]
            for i, s in enumerate(sizes):
                for g, cap in enumerate(buckets):
                    if s <= cap:
                        groups[g].append(i)
                        break
            result: List = [None] * n
            for idx, cap in zip(groups, buckets):
                if not idx:
                    continue
                sub = traceback_batch(
                    [refs[i] for i in idx], [queries[i] for i in idx],
                    [scores[i] for i in idx], [bands[i] for i in idx],
                    gap_open, gap_ext, mat, cigar_cap=cap)
                for i, cg in zip(idx, sub):
                    result[i] = cg
            return result
        cigar_cap = mx
    ref_off = np.zeros(n + 1, dtype=np.int64)
    q_off = np.zeros(n + 1, dtype=np.int64)
    for i in range(n):
        ref_off[i + 1] = ref_off[i] + len(refs[i])
        q_off[i + 1] = q_off[i] + len(queries[i])
    ref_data = np.concatenate(
        [np.asarray(r, dtype=np.uint8) for r in refs]) if n else \
        np.zeros(0, np.uint8)
    q_data = np.concatenate(
        [np.asarray(q, dtype=np.uint8) for q in queries]) if n else \
        np.zeros(0, np.uint8)
    sc = np.asarray(scores, dtype=np.int32)
    bd = np.asarray(bands, dtype=np.int32)
    mat8 = np.ascontiguousarray(mat, dtype=np.int8)
    out = np.zeros((n, cigar_cap), dtype=np.uint32)
    out_len = np.zeros(n, dtype=np.int32)
    bad = lib.banded_traceback_batch(
        ref_data.ctypes.data, ref_off.ctypes.data,
        q_data.ctypes.data, q_off.ctypes.data,
        sc.ctypes.data, bd.ctypes.data, n, gap_open, gap_ext,
        mat8.ctypes.data, out.ctypes.data, cigar_cap, out_len.ctypes.data)
    if bad:
        raise RuntimeError(f"{bad} tracebacks failed (cigar overflow?)")
    # packed-cigar rows as array views (consumers only iterate); avoiding
    # 100K+ tolist() conversions keeps the batched traceback C-bound
    return [out[i, :out_len[i]] for i in range(n)]


def traceback_ptrs(ref_ptrs: np.ndarray, ref_lens: np.ndarray,
                   q_ptrs: np.ndarray, q_lens: np.ndarray,
                   scores: np.ndarray, bands: np.ndarray,
                   gap_open: int, gap_ext: int,
                   mat: np.ndarray) -> List[np.ndarray]:
    """Batched banded traceback over in-place windows (uint64 pointer
    arrays into the per-part export buffers): no window bytes are
    copied to assemble the batch.  Bucketing by rl+ql mirrors
    traceback_batch (one 30K-nt alignment must not inflate every row's
    CIGAR capacity) but runs vectorized."""
    lib = _build()
    assert lib is not None
    n = len(ref_lens)
    result: List = [None] * n
    if n == 0:
        return result
    mat8 = np.ascontiguousarray(mat, dtype=np.int8)
    sizes = ref_lens.astype(np.int64) + q_lens + 8
    mx = int(sizes.max())

    def run(idx: np.ndarray, cap: int) -> None:
        m = len(idx)
        if m == 0:
            return
        rp = np.ascontiguousarray(ref_ptrs[idx], np.uint64)
        rl = np.ascontiguousarray(ref_lens[idx], np.int32)
        qp = np.ascontiguousarray(q_ptrs[idx], np.uint64)
        ql = np.ascontiguousarray(q_lens[idx], np.int32)
        sc = np.ascontiguousarray(scores[idx], np.int32)
        bd = np.ascontiguousarray(bands[idx], np.int32)
        out = np.zeros((m, cap), np.uint32)
        out_len = np.zeros(m, np.int32)
        bad = lib.banded_traceback_ptrs(
            rp.ctypes.data, rl.ctypes.data, qp.ctypes.data,
            ql.ctypes.data, sc.ctypes.data, bd.ctypes.data,
            m, gap_open, gap_ext, mat8.ctypes.data,
            out.ctypes.data, cap, out_len.ctypes.data)
        if bad:
            raise RuntimeError(
                f"{bad} tracebacks failed (cigar overflow?)")
        lens = out_len.tolist()
        for j, i in enumerate(idx.tolist()):
            result[i] = out[j, :lens[j]]

    if mx > 1024 and n > 1:
        lo = 0
        for cap in (1024, 8192, mx):
            run(np.flatnonzero((sizes > lo) & (sizes <= cap)), cap)
            lo = cap
    else:
        run(np.arange(n), mx)
    return result


def gumbel_histogram(match, mismatch, gap_open, gap_ext, freqs,
                     seq_len=2000, n_pairs=160, margin=100,
                     seed=182345345, hist_len=512):
    """Interior island-peak histogram + effective cell count."""
    lib = _build()
    assert lib is not None
    lib.gumbel_island_hist.restype = ctypes.c_int64
    lib.gumbel_island_hist.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int32]
    f = np.ascontiguousarray(freqs, np.float64)
    hist = np.zeros(hist_len, np.int64)
    cells = lib.gumbel_island_hist(
        match, mismatch, gap_open, gap_ext, f.ctypes.data, seq_len,
        n_pairs, margin, seed, hist.ctypes.data, hist_len)
    return hist, int(cells)
