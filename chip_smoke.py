#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sortmerna_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, and no result line is
printed):

1. card: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: every kernel source (csrc/*.cu, one nvcc each for sm_90a), the
   native host library and the ALP oracle, compiled from this checkout in
   parallel; the log quotes ptxas's registers and spill bytes for each
   instantiation of both SW sources (csrc/sw_scan.cu and csrc/sw_scan2.cu,
   which share the wavefront core of csrc/sw_wave.cuh) and of both probe
   kernels (csrc/seed_probe.cu);
3. parity: every SW kernel against its plain PyTorch version on the card,
   bit-exact (int32 equality): sw_scan (4096 x 256 x 256 and 64 x 4096 x
   256, both terminate modes), sw_fused (4096 x 256 x 256, 64 x 2048 x
   2048), sw_scan2 (4096 x 256 x 256 and 512 x 4096 x 256) and sw_fused2
   (4096 x 256 x 256, a ragged 300 x 256 x 256, 64 x 2048 x 2048); then
   sw_scan, sw_scan2 and sw_score_batch (through the sw_scan kernel) on
   query and ref codes in -7..15 (``testing.odd_tiles``); then all four
   SW entries on the edge inputs of ``testing.edge_tiles`` /
   ``edge_block`` (lengths spread over the tile, tie-heavy and
   all-mismatch pairs, gap penalties 5/2, 1/3 and 0/0, a tscore below the
   forward best), plain and with v1's odd chars, at 4096 x 256 x 256 and
   1024 x 1024 x 256; then sw_fused and sw_fused2 on one long true match
   at 1 x 32768 x 32768 (the long-tile route over a cluster of 4 CTAs);
   the 2,048-row tiles above take that route over one CTA;
4. timing: each SW kernel at the main path's block shape (4096 x 256 x
   256) with CUDA events, beside its plain version and its bound;
5. cpu-vs-gpu: the first 2,000 reads aligned by the port's CLI on ``cpu``
   (plain versions) and on ``cuda``; the reports must be byte-identical;
6. probe: seed_probe and seed_compact against their plain versions on
   65,536 windows cut from the reads (a quarter with 1-2 point edits)
   against the workload's index part and on the edge inputs of
   ``testing.probe_edges`` (chains at and past MAX_PROBES, wrapping or
   without EMPTY; groups at the caps; 31 to 376 ids a window; clamped
   r_ids starts, gates, modes, repeated and wrapped ids), full_search off
   and on, bit-exact; then the device tables' bytes, and both kernels
   timed: seed_probe against a bound of one key sector for each distinct
   key the windows need, seed_compact by graph replay and eagerly, beside
   the PyTorch masked select (its ``library_ms``, eager);
7. align: the align task at full size through ``sortmerna_tpu_torch.cli``
   on ``cuda`` -- a synthetic 16S-like database of 4,000 sequences of
   1,300-1,600 nt (about 6 Mnt, 40 families, members about 8% apart) and
   100,000 reads of 100-150 nt (half cut from the database with 0-3
   substitutions and occasional 1-2 nt indels, half random); the
   ``sw_fused`` launch count must be > 0.  It also reports the kernels'
   device time on that run (CUDA events around each launch) and the
   port's host stage timers (``util.timed``);
8. pallas2-align: the same run with ``SMR_PALLAS=2``: every wave block
   through ``sw_fused2`` (launches > 0, ``sw_fused`` none), reports
   byte-identical to phase 7's;
9. device-probe: 2,000 reads with ``-device_probe`` on ``cpu`` and on
   ``cuda`` (byte-identical reports), then the full run with
   ``-device_probe`` on ``cuda``: ``seed_probe`` and ``seed_compact``
   launches > 0, reports byte-identical to phase 7's;
10. sharded-align: the full run as 2 read shards (``run_align_sharded``,
   a thread a shard), every wave block split over [cuda:0, cuda:0] by
   ``MeshSwBackend`` (two ``sw_fused`` launches a block), then the normal
   post-processing and reports: byte-identical to phase 7's, counters
   equal;
11. sharded-device-probe: phase 10 with ``-device_probe``: the two
   shards' threads share the part's device searcher and its output
   buffers; ``seed_probe``, ``seed_compact`` and ``sw_fused`` launches
   > 0, reports byte-identical to phase 7's, counters equal;
12. multihost-align: the full run through two processes of the CLI
   joined by gloo on 127.0.0.1 (``SMR_NPROCS=2``), both on cuda:0, each
   with its own workdir and a shared output prefix: process 0's merged
   reports byte-identical to phase 7's; each process's wall and
   ``sw_fused`` launches;
13. tasks-and-resume: 2,000 reads, ``--task`` 0, 1, 2 and 3, 2 against
   ``--task 4``, and a run hard-exited after its 2nd journal unit then
   resumed: the same reports;
14. long-reads: reads of 120, 500 and 2,000 nt and one of 30,000 on cpu
   and on cuda (byte-identical reports, each device's wall; tiles over
   1,024 rows, so ``sw_fused``'s long-tile route, inside the align), then
   that route timed beside its bound for ``sw_fused`` and ``sw_fused2``
   at ``LONG_TILES`` (1024 x 2048 x 2048, 256 x 4096 x 4096, 64 x 8192 x
   8192, 64 x 32768 x 32768 and 1 x 32768 x 32768);
15. host-path: the python traverse (native library switched off with
   SMR_NO_NATIVE=1, in a child process) on 200 reads, whose SW jobs go
   through ``TorchSwBackend.batch`` -> the ``sw_scan`` kernel.

Before the last line it prints the card line and one JSON line with the
six kernels (launches on their path, ms, plain ms, bound, library ms, and
how each was timed; their launches on phases 10-14 under
``launches_on_other_paths``, and under ``long_tiles`` both fused
kernels' route, ms and bound at each long-read tile); the last line
is ``{"ok": true, "device": {"platform": "gpu", ...}}``.  Details go to
chiprun_out/chip_smoke/.  It takes about seven minutes.

Phases 10 and 11 run the port's threaded paths on the card: read shards
sharing one SW backend and one device searcher.

All four SW entries (sw_scan / sw_fused of csrc/sw_scan.cu, sw_scan2 /
sw_fused2 of csrc/sw_scan2.cu) run the one wavefront core of
csrc/sw_wave.cuh, each source with its own column reads and NEG.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
T0 = time.perf_counter()

# int32 instructions a DP cell of the SW recurrence needs on sm_90a, with
# its DPX instructions: E = max(E - ge, Hgo) and F = max(F - ge, Hgo_up)
# one __viaddmax_s32 each; max(E, F) one; H = max(diag + sub, max(E, F), 0)
# one __viaddmax_s32_relu; Hgo = H - go one, shared by the next row's F
# and the next column's E; the column max one.  The note of
# csrc/sw_wave.cuh (the wavefront core of both SW sources) refers to it.
OPS_PER_CELL = 6
INT32_LANES_PER_SM = 64      # CUDA programming guide, cc 9.0 throughput
N_READS = 100000             # reads of the align phases
N_WINDOWS = 65536            # windows of the probe phase (one full batch)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
SECTOR = 32                  # bytes: the least a random lookup reads


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    from sortmerna_tpu_torch.tools.ab import card_line
    return card_line()


def max_sm_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 2, graph: bool = False) -> float:
    """Device ms a call of ``fn`` (CUDA events; ``graph``: replayed from a
    CUDA graph), the timer the A/B tools use too."""
    from sortmerna_tpu_torch.tools.ab import cuda_ms
    return cuda_ms(fn, iters, warmup, graph)


def launches() -> dict:
    """Every kernel's launch count since the last reset_launches()."""
    from sortmerna_tpu_torch.ops import seed_search as S
    from sortmerna_tpu_torch.ops import sw_kernels as K
    return dict(K.LAUNCHES, **S.LAUNCHES)


def reset_launches() -> None:
    from sortmerna_tpu_torch.ops import seed_search as S
    from sortmerna_tpu_torch.ops import sw_kernels as K
    K.reset_launches()
    S.reset_launches()


# ---------------------------------------------------------------- inputs


def scan_inputs(rng, B, Lq, Lr, device):
    """testing.scan_tiles on ``device``: Q, row_valid, R, col_valid as
    tensors, plus the numpy row / column lengths."""
    import torch
    from sortmerna_tpu_torch.testing import scan_tiles
    Q, rv, R, cv, qlen, rlen = scan_tiles(rng, B, Lq, Lr)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(Q), t(rv), t(R), t(cv), qlen, rlen


MAX_ABS_ERR = {}


def equal_or_raise(name, got, want):
    """Bit-exact (integer equality) or raise; records the max |got - want|
    per kernel for the kernels line."""
    import torch
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu().long(), w.cpu().long()
        if g.shape != w.shape:
            raise AssertionError(f"{name}: output {i} has shape "
                                 f"{tuple(g.shape)}, want {tuple(w.shape)}")
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: output {i} differs at {bad}")
        err = max(err, int((g - w).abs().max()) if g.numel() else 0)
    key = name.split()[0]
    MAX_ABS_ERR[key] = max(MAX_ABS_ERR.get(key, 0), err)


def ptxas_report(text):
    """(kernel<K>, registers, spill bytes stored + loaded) for each entry
    function of an ``nvcc -Xptxas -v`` log, in its order."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d((?:sw|seed)_\w+?_kernel)(?:ILi(\d+)E)?",
                          m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else m.group(1))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


# ---------------------------------------------------------------- phases


def phase_build():
    from sortmerna_tpu_torch import native
    from sortmerna_tpu_torch.ops import seed_search, sw_kernels
    from sortmerna_tpu_torch.stats import alp_exact
    errs = []
    done = {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errs.append((name, e))
        done[name] = time.perf_counter() - t

    ths = [threading.Thread(target=run, args=a) for a in (
        ("kernels (nvcc)", lambda: sw_kernels.build(force=True)),
        ("native", native.get_lib),
        ("alp_oracle", alp_exact.oracle_bin))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    if errs:
        raise RuntimeError(f"build of {errs[0][0]} failed: {errs[0][1]}")
    if not native.have_native():
        raise RuntimeError("the native host library did not build/load")
    if not alp_exact.available():
        # the package ships the ALP tree, so the reference statistics must
        # come from it, not from the estimator
        raise RuntimeError("the ALP oracle did not build")
    stems = sorted(p.stem for p in sw_kernels.CSRC.glob("*.cu"))
    for stem in ("sw_scan", "sw_scan2"):
        sw_kernels.load_library(stem)
    seed_search._lib()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for stem in stems:
            f.write(f"==== csrc/{stem}.cu\n"
                    + sw_kernels.build_log(stem).read_text())
    log("build: " + ", ".join(f"{k} {v:.1f}s" for k, v in done.items())
        + f" ({', '.join(stems)}); ptxas report in "
        "chiprun_out/chip_smoke/ptxas.txt")
    report = {}
    for stem, note in (("sw_scan", "<K>: K rows a lane at most; *_long_"
                        "kernel: the long-tile route, 512 threads at most"),
                       ("sw_scan2", "the same"),
                       ("seed_probe", "seed_probe_kernel<NP>: NP probes a "
                        "lane, 4 at pw 9")):
        report[stem] = ptxas_report(sw_kernels.build_log(stem).read_text())
        log(f"ptxas {stem}.cu (registers, spill bytes; {note}): "
            + ", ".join(f"{n} {r} regs {s} spill"
                        for n, r, s in report[stem]))
    return report


def phase_parity(mat):
    import numpy as np
    import torch
    from sortmerna_tpu_torch.ops import sw_kernels as K
    from sortmerna_tpu_torch.testing import fused_block
    rng = np.random.default_rng(123)
    dev = torch.device("cuda")
    scans = (("sw_scan", K.sw_scan, K.sw_scan_plain,
              ((4096, 256, 256), (64, 4096, 256))),
             ("sw_scan2", K.sw_scan2, K.sw_scan2_plain,
              ((4096, 256, 256), (512, 4096, 256))))
    for name, kernel, plain, shapes in scans:
        for (B, Lq, Lr) in shapes:
            Q, rv, R, cv, _, _ = scan_inputs(rng, B, Lq, Lr, dev)
            for term in (False, True):
                ts = None
                if term:  # stop at the forward best: the begin-pass regime
                    ts = plain(Q, rv, R, cv, mat, 5, 2, False, None)[0]
                got = kernel(Q, rv, R, cv, mat, 5, 2, term, ts)
                torch.cuda.synchronize()
                want = plain(Q, rv, R, cv, mat, 5, 2, term, ts)
                equal_or_raise(f"{name} {B}x{Lq}x{Lr} terminate={term}",
                               got, want)
                log(f"parity {name} {B}x{Lq}x{Lr} terminate={term}: "
                    "bit-exact")
    fused = (("sw_fused", K.sw_fused, K.sw_fused_plain,
              ((4096, 256, 256), (64, 2048, 2048))),
             ("sw_fused2", K.sw_fused2, K.sw_fused2_plain,
              ((4096, 256, 256), (300, 256, 256), (64, 2048, 2048))))
    for name, kernel, plain, shapes in fused:
        for (B, lq, lr) in shapes:
            buf = torch.from_numpy(fused_block(rng, B, lq, lr)).to(dev)
            got = kernel(buf, mat, B, lq, lr, 5, 2)
            torch.cuda.synchronize()
            want = plain(buf, mat, B, lq, lr, 5, 2)
            equal_or_raise(f"{name} {B}x{lq}x{lr}", got, want)
            n_pass = int((got[1] >= 0).sum())
            log(f"parity {name} {B}x{lq}x{lr}: bit-exact "
                f"({n_pass}/{B} pairs pass to the begin pass)")
    phase_parity_odd_codes(mat)
    phase_parity_edges(mat)
    phase_parity_long(mat)


def phase_parity_odd_codes(mat):
    """sw_scan, sw_scan2 and sw_score_batch (the sw_scan kernel reading
    its ref chars by take_along_axis) on query and ref codes in -7..15."""
    import numpy as np
    import torch
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import sw_kernels as K
    rng = np.random.default_rng(654)
    dev = torch.device("cuda")
    for (B, Lq, Lr) in ((4096, 256, 256), (512, 2048, 128)):
        Q, rv, R, cv, qlen, rlen = (torch.from_numpy(a).to(dev)
                                    for a in T.odd_tiles(rng, B, Lq, Lr))
        for name, kernel, plain in (("sw_scan", K.sw_scan, K.sw_scan_plain),
                                    ("sw_scan2", K.sw_scan2,
                                     K.sw_scan2_plain)):
            best = plain(Q, rv, R, cv, mat, 5, 2, False, None)[0]
            for term in (False, True):
                ts = best if term else None
                got = kernel(Q, rv, R, cv, mat, 5, 2, term, ts)
                torch.cuda.synchronize()
                equal_or_raise(f"{name} odd codes {B}x{Lq}x{Lr} "
                               f"terminate={term}", got,
                               plain(Q, rv, R, cv, mat, 5, 2, term, ts))
        best = K.sw_score_batch_plain(Q, qlen, R, rlen, mat, 5, 2)[0]
        for term in (False, True):
            ts = best if term else None
            got = K.sw_score_batch(Q, qlen, R, rlen, mat, 5, 2, term, ts)
            torch.cuda.synchronize()
            equal_or_raise(f"sw_scan (sw_score_batch) odd codes "
                           f"{B}x{Lq}x{Lr} terminate={term}", got,
                           K.sw_score_batch_plain(Q, qlen, R, rlen, mat, 5,
                                                  2, term, ts))
        log(f"parity sw_scan / sw_scan2 / sw_score_batch on codes -7..15 "
            f"{B}x{Lq}x{Lr}, both terminate modes: bit-exact")


def phase_parity_edges(mat):
    """All four SW entries on the edge inputs, plain and with v1's odd
    chars (codes -7..15, nibbles 0..15), at each edge gap pair."""
    import numpy as np
    import torch
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import sw_kernels as K
    rng = np.random.default_rng(321)
    dev = torch.device("cuda")
    scans = (("sw_scan", K.sw_scan, K.sw_scan_plain),
             ("sw_scan2", K.sw_scan2, K.sw_scan2_plain))
    fused = (("sw_fused", K.sw_fused, K.sw_fused_plain),
             ("sw_fused2", K.sw_fused2, K.sw_fused2_plain))
    for (B, L, Lr) in ((4096, 256, 256), (1024, 1024, 256)):
        for odd in (False, True):
            Q, rv, R, cv = (torch.from_numpy(a).to(dev)
                            for a in T.edge_tiles(rng, B, L, Lr, odd=odd))
            for go, ge in T.EDGE_GAPS:
                for name, kernel, plain in scans:
                    best = plain(Q, rv, R, cv, mat, go, ge, False, None)[0]
                    for term in (False, True):
                        ts = torch.from_numpy(T.edge_tscore(
                            rng, best.cpu().numpy())).to(dev) \
                            if term else None
                        got = kernel(Q, rv, R, cv, mat, go, ge, term, ts)
                        torch.cuda.synchronize()
                        want = plain(Q, rv, R, cv, mat, go, ge, term, ts)
                        equal_or_raise(
                            f"{name} edge{' odd' * odd} {B}x{L}x{Lr} gaps "
                            f"{go}/{ge} terminate={term}", got, want)
            buf = torch.from_numpy(T.edge_block(rng, B, L, Lr,
                                                odd=odd)).to(dev)
            for go, ge in T.EDGE_GAPS:
                for name, kernel, plain in fused:
                    got = kernel(buf, mat, B, L, Lr, go, ge)
                    torch.cuda.synchronize()
                    want = plain(buf, mat, B, L, Lr, go, ge)
                    equal_or_raise(f"{name} edge{' odd' * odd} {B}x{L}x{Lr} "
                                   f"gaps {go}/{ge}", got, want)
            log(f"parity sw_scan / sw_fused / sw_scan2 / sw_fused2 edge "
                f"inputs{' with odd chars' * odd} {B}x{L}x{Lr}, gaps "
                + ", ".join(f"{go}/{ge}" for go, ge in T.EDGE_GAPS)
                + ", both terminate modes: bit-exact")


# the long-tile route's timing tiles (B, lq, lr, timed launches): the
# long-read buckets' blocks as TorchSwBackend forms them, and one
# 30,000-nt read alone (its latency)
LONG_TILES = ((1024, 2048, 2048, 10), (256, 4096, 4096, 5),
              (64, 8192, 8192, 5), (64, 32768, 32768, 3),
              (1, 32768, 32768, 3))
LONG_PLAIN_MS = {}      # (name, B, lq, lr) -> the plain version's ms


def phase_parity_long(mat):
    """Both fused entries against their plain versions on one 30,000-nt
    class pair, 1 x 32768 x 32768 (a cluster of 4 CTAs), bit-exact; the
    plain version's time is kept for the long-tile timing."""
    import numpy as np
    import torch
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import sw_kernels as K
    B, lq, lr = 1, 32768, 32768
    buf = torch.from_numpy(T.long_block(np.random.default_rng(77), B, lq,
                                        lr)).cuda()
    for name in ("sw_fused", "sw_fused2"):
        got = getattr(K, name)(buf, mat, B, lq, lr, 5, 2)
        torch.cuda.synchronize()
        plain = getattr(K, name + "_plain")
        want = []
        ms = cuda_ms(lambda: want.append(plain(buf, mat, B, lq, lr, 5, 2)),
                     1, warmup=0)
        LONG_PLAIN_MS[name, B, lq, lr] = ms
        equal_or_raise(f"{name} {B}x{lq}x{lr}", got, want[0])
        log(f"parity {name} {B}x{lq}x{lr}: bit-exact (score "
            f"{int(got[0, 0])}, begin pass to column {int(got[1, 0])}; "
            f"plain {ms / 1e3:.1f} s)")


def int32_rate() -> float:
    """The card's int32 operations a second: SMs x int32 lanes x the
    maximum SM clock."""
    import torch
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * INT32_LANES_PER_SM \
        * max_sm_clock_hz()


def sw_bound(cells, nbytes, rate):
    """bound_ms of an SW call: the larger of its DP cells' int32 operations
    over ``rate`` and its bytes over the memory rate."""
    ops_ms = cells * OPS_PER_CELL / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def fused_cells(buf, out, lq, lr) -> int:
    """DP cells a fused call computes on these inputs: every valid cell of
    the forward pass, and for each pair that passes to the begin pass the
    rows up to end_read by the columns from end_ref back to beg_ref (where
    it terminates)."""
    import numpy as np
    o = out.cpu().numpy().astype(np.int64)
    ints = buf[:, lq // 2 + lr // 2:].cpu().numpy().view("<i4")
    ql = ints[:, 0].clip(0, lq).astype(np.int64)
    rl = ints[:, 1].clip(0, lr).astype(np.int64)
    ok = o[1] >= 0
    return int((ql * rl).sum()
               + ((o[4][ok] + 1) * (o[2][ok] - o[1][ok] + 1)).sum())


def phase_timing(mat):
    import numpy as np
    import torch
    from sortmerna_tpu_torch.ops import sw_kernels as K
    from sortmerna_tpu_torch.testing import fused_block
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    rate = int32_rate()
    B, lq, lr = 4096, 256, 256
    res = {}

    def bound(cells, nbytes):
        return sw_bound(cells, nbytes, rate)

    # the fused kernels at the main path's block shape, on one block
    buf = torch.from_numpy(fused_block(rng, B, lq, lr, False)).to(dev)
    out = K.sw_fused(buf, mat, B, lq, lr, 5, 2)
    cells = fused_cells(buf, out, lq, lr)
    nbytes = buf.numel() + out.numel() * 4
    for name, kernel, plain in (("sw_fused", K.sw_fused, K.sw_fused_plain),
                                ("sw_fused2", K.sw_fused2,
                                 K.sw_fused2_plain)):
        ms = cuda_ms(lambda: kernel(buf, mat, B, lq, lr, 5, 2), 20)
        plain_ms = cuda_ms(lambda: plain(buf, mat, B, lq, lr, 5, 2), 2,
                           warmup=1)
        res[name] = dict(ms=ms, timed_by="CUDA events over 20 launches",
                         plain_ms=plain_ms, cells=cells,
                         **bound(cells, nbytes))

    # the scans (forward, no terminate) at the same tile shape
    Q, rv, R, cv, qlen, rlen = scan_inputs(rng, B, lq, lr, dev)
    cells = int((qlen.astype(np.int64) * rlen).sum())
    nbytes = (Q.numel() + R.numel()) * 4 + rv.numel() + cv.numel() + 3 * B * 4
    for name, kernel, plain in (("sw_scan", K.sw_scan, K.sw_scan_plain),
                                ("sw_scan2", K.sw_scan2, K.sw_scan2_plain)):
        ms = cuda_ms(lambda: kernel(Q, rv, R, cv, mat, 5, 2, False), 20)
        plain_ms = cuda_ms(lambda: plain(Q, rv, R, cv, mat, 5, 2, False,
                                         None), 2, warmup=1)
        res[name] = dict(ms=ms, timed_by="CUDA events over 20 launches",
                         plain_ms=plain_ms, cells=cells,
                         **bound(cells, nbytes))
    for k, v in res.items():
        log(f"timing {k} {B}x{lq}x{lr}: {v['ms']:.4f} ms (plain "
            f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.4f} ms over "
            f"{v['cells']} cells at {rate / 1e12:.2f} int32 Top/s)")
    log("timing v1 / v2 on the same blocks: sw_fused / sw_fused2 "
        f"{res['sw_fused']['ms'] / res['sw_fused2']['ms']:.3f}x, sw_scan / "
        f"sw_scan2 {res['sw_scan']['ms'] / res['sw_scan2']['ms']:.3f}x")
    return res


def load_part(db):
    """The workload's index part 0 as the CLI loads it (built by the
    cpu-vs-gpu phase)."""
    from sortmerna_tpu_torch import cli
    from sortmerna_tpu_torch.index.artifact import build_or_load
    top = os.path.dirname(db)
    opts = cli.parse_args(["-ref", db, "-reads", db, "-idx-dir",
                           os.path.join(top, "idx"),
                           "-workdir", os.path.join(top, "wd_probe_load")])
    return build_or_load(db, opts.idx_dir, opts.interval, opts.max_pos,
                         opts.max_file_size,
                         seed_win_len=opts.seed_win_len).parts[0]


def table_bytes(tabs):
    """Bytes of a searcher's device tables: keys, values, r_ids and the
    home bitmaps."""
    def size(suffix):
        return sum(t.numel() * t.element_size() for k, t in tabs.items()
                   if k.endswith(suffix))
    return dict(keys=size("_keys"), values=size("_val"),
                r_ids=size("r_ids"), home=size("_home"))


def phase_probe_edges():
    """Both probe kernels on the edge inputs of ``testing.probe_edges``,
    full_search off and on, against the plain versions."""
    import torch
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import seed_search as S
    dev = torch.device("cuda")
    for c in T.probe_edges():
        host = {k: torch.from_numpy(v) for k, v in c["tabs"].items()}
        tabs = S.with_home_bits({k: v.to(dev) for k, v in host.items()})
        w1, w2 = (torch.from_numpy(c[k].astype("int32")) for k in ("w1", "w2"))
        for full_search in (False, True):
            args = (c["pw"], full_search, c["minoccur"])
            count, ids = S.seed_probe(tabs, w1.to(dev), w2.to(dev), *args)
            win, got, total = S.seed_compact(count, ids, c["pw"])
            torch.cuda.synchronize()
            want = S.probe_windows_plain(host, w1.long(), w2.long(), *args)
            equal_or_raise(f"seed_probe edges {c['name']} "
                           f"full_search={full_search}",
                           S.seed_compact_plain(count, ids), want)
            n = int(total[0])
            equal_or_raise(f"seed_compact edges {c['name']} "
                           f"full_search={full_search}",
                           (win[:n], got[:n]), want)
            pairs = set(zip(want[0].tolist(), want[1].tolist()))
            if not (all(p in pairs for p in c["present"])
                    and not any(p in pairs for p in c["absent"])):
                raise AssertionError(f"probe edges {c['name']}: the case's "
                                     "expected pairs do not hold")
        log(f"parity seed_probe/seed_compact edge inputs {c['name']} "
            f"({len(c['w1'])} windows, tables of "
            f"{len(c['tabs']['fx_keys'])} slots), full_search off and on: "
            "bit-exact")


def phase_probe(db, reads):
    """seed_probe / seed_compact against their plain versions on one full
    batch of windows and on the edge inputs, then timed, with the bytes
    their work needs."""
    import torch
    from sortmerna_tpu_torch.ops import seed_search as S
    from sortmerna_tpu_torch.testing import read_windows
    dev = torch.device("cuda")
    part = load_part(db)
    L = getattr(part, "seed_win_len", 18)
    pw = L // 2
    K = S.ids_per_window(pw)
    w1n, w2n = read_windows(reads, L, N_WINDOWS, seed=11)
    w1 = torch.from_numpy(w1n).to(dev, torch.int32)
    w2 = torch.from_numpy(w2n).to(dev, torch.int32)
    for full_search in (False, True):
        searcher = S.DeviceSeedSearcher(part, 0, full_search, device=dev)
        tabs = searcher.tabs
        count, ids = S.seed_probe(tabs, w1, w2, pw, full_search, 0)
        win, got, total = S.seed_compact(count, ids, pw)
        torch.cuda.synchronize()
        want = S.probe_windows_plain(tabs, w1.long(), w2.long(), pw,
                                     full_search, 0)
        # seed_probe's counts and ids, read through the plain compaction
        equal_or_raise(f"seed_probe full_search={full_search}",
                       S.seed_compact_plain(count, ids), want)
        n = int(total[0])
        equal_or_raise(f"seed_compact full_search={full_search}",
                       (win[:n], got[:n]), want)
        log(f"parity seed_probe/seed_compact {N_WINDOWS} windows "
            f"(L={L}) full_search={full_search}: bit-exact, "
            f"{len(want[0])} (window, id) pairs, "
            f"{int((count > 0).sum())} windows with a hit")
    phase_probe_edges()

    # timing, default search (full_search off, minoccur 0), into the
    # searcher's persistent buffers as the path does
    searcher = S.DeviceSeedSearcher(part, 0, False, device=dev)
    tabs = searcher.tabs
    tb = table_bytes(tabs)
    log("device tables: " + ", ".join(f"{k} {v / 1e6:.1f} MB"
                                      for k, v in tb.items())
        + f"; keys, values and r_ids together "
        f"{(tb['keys'] + tb['values'] + tb['r_ids']) / 1e6:.1f} MB against "
        "the 50 MB L2")
    bufs = searcher._buffers(N_WINDOWS)
    count, ids = S.seed_probe(tabs, w1, w2, pw, False, 0, out=bufs["probe"])
    pairs = int(count.sum())
    # the lookups these windows need: the two 0-error keys, and in the
    # other mode (no 0-error hit behind an open gate) the distinct keys of
    # each subsearch whose gate (kmer_counts > minoccur) is open, varying
    # w2 on the F side and w1 on the R side.  Of the 9pw probes the JAX
    # package enumerates a side (4pw substitutions, pw deletions, 4pw
    # insertions), pw substitutions put back the char in place (the
    # 0-error key, counted already), pw - 1 insertions repeat another
    # insertion's key, and deleting any char of a run of equal chars gives
    # one key: 3pw + (3pw + 1) + (runs of the half) distinct keys.  The
    # bound counts those; the count of every enumerated probe is logged
    # beside it.
    w1l, w2l = w1.long(), w2.long()
    key0 = (w1l << (2 * pw)) | w2l
    zf = S._probe_table(tabs["fx_keys"], tabs["fx_val"], key0)[0]
    rzf = S._probe_table(tabs["rx_keys"], tabs["rx_val"], key0)[0]
    gate_f = tabs["kmer_counts"][w1l] > 0
    gate_r = tabs["kmer_counts"][w2l] > 0
    other = ~((zf & gate_f) | (rzf & gate_r))

    def runs(x):
        c = torch.stack([(x >> (2 * i)) & 3 for i in range(pw)])
        return 1 + (c[1:] != c[:-1]).sum(0)

    open_f, open_r = other & gate_f, other & gate_r
    sides = int(open_f.sum() + open_r.sum())
    lookups = 2 * N_WINDOWS + (6 * pw + 1) * sides + int(
        runs(w2l)[open_f].sum() + runs(w1l)[open_r].sum())
    probes = 2 * N_WINDOWS + 9 * pw * sides

    def probe_bytes(n):
        # w1, w2 in, a 32-byte key sector a lookup, a count and an id out
        return 8 * N_WINDOWS + SECTOR * n + 4 * N_WINDOWS + 4 * pairs

    res = {}
    res["seed_probe"] = dict(
        ms=cuda_ms(lambda: S.seed_probe(tabs, w1, w2, pw, False, 0,
                                        out=bufs["probe"]), 20),
        timed_by="CUDA events over 20 launches",
        plain_ms=cuda_ms(lambda: S.probe_windows_plain(
            tabs, w1.long(), w2.long(), pw, False, 0), 2, warmup=1),
        bound_ms=probe_bytes(lookups) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, lookups=lookups,
        bound_ms_every_probe=probe_bytes(probes) / HBM_BYTES_PER_S * 1e3,
        probes=probes, open_sides=sides, pairs=pairs, windows=N_WINDOWS,
        table_bytes=tb)
    # seed_compact: the counts in, each kept id in, a pair and the total
    # out (its time includes the scan of the counts)
    nbytes = 4 * N_WINDOWS + 4 * pairs + 8 * pairs + 4

    def library():
        # the PyTorch route: a mask of each row's first count ids
        mask = torch.arange(K, device=dev)[None, :] < count[:, None]
        return ids[mask], mask.nonzero()

    def compact():
        return S.seed_compact(count, ids, pw, out=bufs["compact"])

    # ms from a graph replay (the launch is shorter than its wrapper's
    # host time); eager_ms from eager launches, timed as library_ms is
    res["seed_compact"] = dict(
        ms=cuda_ms(compact, 50, graph=True),
        timed_by="CUDA graph replay of 50 launches; eager_ms and library_ms "
                 "CUDA events over eager calls",
        eager_ms=cuda_ms(compact, 50),
        plain_ms=cuda_ms(lambda: S.seed_compact_plain(count, ids), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(library, 50),
        pairs=pairs, windows=N_WINDOWS)
    v = res["seed_probe"]
    log(f"timing seed_probe {N_WINDOWS} windows: {v['ms']:.4f} ms (plain "
        f"{v['plain_ms']:.2f} ms; bound {v['bound_ms']:.4f} ms over "
        f"{lookups} distinct lookups, bound / ms "
        f"{v['bound_ms'] / v['ms']:.1%}; over every enumerated probe "
        f"({probes}, 9pw a side) {v['bound_ms_every_probe']:.4f} ms, "
        f"{v['bound_ms_every_probe'] / v['ms']:.1%}; {sides} open sides, "
        f"{pairs} pairs)")
    v = res["seed_compact"]
    log(f"timing seed_compact {N_WINDOWS} windows: {v['ms']:.4f} ms by "
        f"graph replay, {v['eager_ms']:.4f} ms eager (plain "
        f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.4g} ms, library "
        f"{v['library_ms']:.4f} ms eager; {pairs} pairs)")
    return res


def run_cli(argv, device):
    from sortmerna_tpu_torch.cli import main
    os.environ["SMR_TORCH_DEVICE"] = device
    main(argv)


def make_workload(top, n_reads):
    from sortmerna_tpu_torch import testing as T
    db = os.path.join(top, "db16s.fasta")
    reads = os.path.join(top, "reads.fasta")
    t = time.perf_counter()
    seqs = T.make_db(db, 4000, n_families=40, len_range=(1300, 1600),
                     divergence=0.08, seed=2024)
    T.make_reads(reads, seqs, n_reads, len_range=(100, 150), seed=2025)
    nt = sum(len(s) for s in seqs)
    log(f"workload: {len(seqs)} ref seqs, {nt} nt; {n_reads} reads "
        f"({time.perf_counter() - t:.1f}s to make)")
    return db, reads


COUNTERS = ("all_reads_count", "num_aligned", "num_short", "num_denovo",
            "n_yid_ycov", "n_yid_ncov", "n_nid_ycov", "total_otu",
            "reads_matched_per_db")


def counters(readstats) -> dict:
    """A run's Readstats counters, as its aligned.log reports them."""
    return {k: getattr(readstats, k) for k in COUNTERS}


def head_reads(src, dst, n):
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 2 * n:
                break
            g.write(line)


def cli_argv(top, db, reads, wd, extra=()):
    from sortmerna_tpu_torch import testing as T
    return (["-ref", db, "-reads", reads] + T.VERIFY_FLAGS + list(extra)
            + ["-idx-dir", os.path.join(top, "idx"), "-workdir", wd])


def same_reports(what, a_dir, b_dir):
    """Raise unless the reports in the two directories (each run's out/,
    or a multi-host run's shared output directory) are byte-identical;
    returns the aligned.fa record count."""
    from sortmerna_tpu_torch import testing as T
    a = T.read_outputs(a_dir)
    b = T.read_outputs(b_dir)
    if a != b or len(a) < 7:
        bad = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        raise AssertionError(f"{what}: reports differ: {bad} "
                             f"({len(a)} and {len(b)} reports)")
    return a["aligned.fa"].count(b">")


def phase_cpu_vs_gpu(top, db, reads, extra=(), tag="cpu-vs-gpu",
                     path_kernels=("sw_fused",)):
    """The first 2,000 reads on cpu and on cuda: byte-identical reports;
    on cuda every kernel of ``path_kernels`` launched, on cpu none."""
    sub = os.path.join(top, "reads2k.fasta")
    head_reads(reads, sub, 2000)
    wds, walls = {}, {}
    for dev in ("cpu", "cuda"):
        wds[dev] = os.path.join(top, f"wd2k_{tag}_{dev}")
        t = time.perf_counter()
        reset_launches()
        run_cli(cli_argv(top, db, sub, wds[dev], extra), dev)
        got = launches()
        log(f"{tag}: 2000 reads on {dev} in "
            f"{time.perf_counter() - t:.1f}s, launches {got}")
        ran = all(got[k] > 0 for k in path_kernels) if dev == "cuda" \
            else not any(got.values())
        if not ran:
            raise AssertionError(f"{tag}: launches on {dev}: {got}")
    n_al = same_reports(tag, os.path.join(wds["cpu"], "out"),
                        os.path.join(wds["cuda"], "out"))
    log(f"{tag}: reports byte-identical ({n_al} aligned reads in "
        "aligned.fa)")
    return wds["cuda"]


def phase_align(top, db, reads, n_reads, tag, extra=(), env=None,
                path_kernels=("sw_fused",), idle_kernels=(),
                same_as=None):
    """The align task on ``cuda`` with the stage timers on; every kernel
    of ``path_kernels`` must launch and none of ``idle_kernels``.  Device
    time: a pair of CUDA events around each launch of the path's kernels
    (the H2D copy is queued before the first, the D2H after the second,
    so each pair spans the kernel alone)."""
    import glob
    import torch
    from sortmerna_tpu_torch import native, util
    from sortmerna_tpu_torch.engine import run as run_mod
    from sortmerna_tpu_torch.ops import seed_search, sw_torch
    wd = os.path.join(top, f"wd_{tag}")
    events = []
    # the launching functions, as their callers look them up
    hooks = {"sw_fused": (sw_torch, "sw_fused"),
             "sw_fused2": (sw_torch, "sw_fused2"),
             "seed_probe": (seed_search, "seed_probe"),
             "seed_compact": (seed_search, "seed_compact")}
    saved = {}

    def evented(fn):
        def inner(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events.append(ev)
            return out
        return inner

    # host clock around the task's phases as run_all calls them
    phase_s = {}
    phases = {n: getattr(run_mod, n) for n in
              ("prepare", "run_align", "run_postprocess", "run_reports")}

    captured = {}

    def clocked(name, fn):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                captured.setdefault(name, out)  # prepare's context
                return out
            finally:
                phase_s[name] = phase_s.get(name, 0.0) \
                    + time.perf_counter() - t0
        return inner

    for k in path_kernels:
        mod, name = hooks[k]
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, evented(saved[(mod, name)]))
    for n, fn in phases.items():
        setattr(run_mod, n, clocked(n, fn))
    env = env or {}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    util.TIMERS.clear()
    reset_launches()
    t = time.perf_counter()
    try:
        run_cli(cli_argv(top, db, reads, wd, extra), "cuda")
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        for n, fn in phases.items():
            setattr(run_mod, n, fn)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t
    phase_s["other"] = secs - sum(phase_s.values())
    got = launches()
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    stages = sorted(((k, v[0], v[1]) for k, v in util.TIMERS.items()),
                    key=lambda r: -r[1])
    with open(os.path.join(OUT_DIR, f"align_stages_{tag}.txt"), "w") as f:
        f.write(f"wall {secs:.3f}s; kernel time ({', '.join(path_kernels)}) "
                f"{kernel_s:.3f}s over {len(events)} launches\n"
                "run_all phases: "
                + ", ".join(f"{k} {v:.3f}s" for k, v in phase_s.items())
                + "\nstage timers (util.timed, nested):\n")
        f.writelines(f"{k:32s} {s:9.3f}s x{n}\n" for k, s, n in stages)
    for k in path_kernels:
        if got[k] <= 0:
            raise AssertionError(f"{tag}: the run launched no {k} kernel: "
                                 f"{got}")
    for k in idle_kernels:
        if got[k] != 0:
            raise AssertionError(f"{tag}: the run launched {k}: {got}")
    if not native.have_native():
        raise AssertionError("the native host library is not loaded")
    log_txt = open(os.path.join(wd, "out", "aligned.log")).read()
    aligned = int(log_txt.split("passing E-value threshold = ")[1]
                  .split()[0])
    if not 0 < aligned < n_reads:
        raise AssertionError(f"degenerate run: {aligned} of {n_reads}")
    # which provider gave lambda / K (refstats caches it in the index dir)
    providers = sorted({json.load(open(p))["provider"] for p in glob.glob(
        os.path.join(top, "idx", "gumbel_*.json"))})
    if providers != ["alp"]:
        raise AssertionError(f"Gumbel parameters from {providers}, not alp")
    if same_as is not None:
        same_reports(f"{tag} against {os.path.basename(same_as)}",
                     os.path.join(wd, "out"), os.path.join(same_as, "out"))
    log(f"{tag}: {n_reads} reads, {aligned} aligned (Gumbel provider "
        f"alp), {secs:.2f}s, {n_reads / secs:.1f} reads/s, launches {got}"
        + (f"; reports byte-identical to {os.path.basename(same_as)}'s"
           if same_as else ""))
    log(f"{tag}: kernels ({', '.join(path_kernels)}) busy {kernel_s:.3f}s "
        f"of {secs:.2f}s ({100 * kernel_s / secs:.2f}%); phases "
        + ", ".join(f"{k} {v:.2f}s" for k, v in phase_s.items())
        + "; host stages "
        + ", ".join(f"{k} {s:.2f}s" for k, s, _ in stages[:6])
        + f" (all in chiprun_out/chip_smoke/align_stages_{tag}.txt)")
    return wd, dict(reads=n_reads, aligned=aligned, gumbel_provider="alp",
                    seconds=secs, reads_per_s=n_reads / secs, launches=got,
                    kernel_seconds=kernel_s, phases=phase_s,
                    counters=counters(captured["prepare"].readstats),
                    stages={k: [s, n] for k, s, n in stages})


def phase_sharded_align(top, db, reads, n_reads, wd_full, full,
                        tag="sharded-align", extra=(),
                        path_kernels=("sw_fused",)):
    """The align task as 2 read shards (run_align_sharded, a thread a
    shard) whose SW waves go through MeshSwBackend over [cuda:0, cuda:0]:
    every wave block is split in two slices, each a real sw_fused launch,
    and the results are concatenated back.  Then the normal
    post-processing, OTU map, summary and reports, which must be
    byte-identical to the align phase's, with the summed counters equal
    to that run's; every kernel of ``path_kernels`` must launch.  With
    ``-device_probe`` in ``extra`` both shards probe through the part's
    one device searcher."""
    import torch
    from sortmerna_tpu_torch import cli
    from sortmerna_tpu_torch.constants import scoring_matrix_5x5
    from sortmerna_tpu_torch.engine import postprocess, run
    from sortmerna_tpu_torch.parallel.dist import (MeshSwBackend,
                                                   run_align_sharded)
    from sortmerna_tpu_torch.reports.summary import write_summary
    wd = os.path.join(top, f"wd_{tag}")
    opts = cli.parse_args(cli_argv(top, db, reads, wd, extra))
    devices = [torch.device("cuda", 0)] * 2
    reset_launches()
    t = time.perf_counter()
    opts.finalize()
    ctx = run.prepare(opts)
    backend = MeshSwBackend(
        scoring_matrix_5x5(opts.match, opts.mismatch, opts.score_n),
        opts.gap_open, opts.gap_ext, devices)
    t_align = time.perf_counter()
    run_align_sharded(ctx, devices, sw_backend=backend)
    t_align = time.perf_counter() - t_align
    otu = run.run_postprocess(ctx)
    out_dir = os.path.dirname(opts.aligned_pfx)
    os.makedirs(out_dir, exist_ok=True)
    postprocess.write_otu_map(otu, os.path.join(out_dir, "otu_map.txt"))
    write_summary(opts, ctx.refstats, ctx.readstats, len(otu))
    run.run_reports(ctx, otu)
    secs = time.perf_counter() - t
    got = launches()
    for k in path_kernels:
        if got[k] <= 0:
            raise AssertionError(f"{tag} launched no {k}: {got}")
    n_al = same_reports(f"{tag} against align", out_dir,
                        os.path.join(wd_full, "out"))
    mine = counters(ctx.readstats)
    if mine != full["counters"]:
        raise AssertionError(f"{tag}: counters {mine} differ from "
                             f"the align phase's {full['counters']}")
    log(f"{tag}: {n_reads} reads as 2 shards over [cuda:0, cuda:0]"
        f"{' with ' + ' '.join(extra) if extra else ''}, {n_al} aligned, "
        f"{secs:.2f}s ({t_align:.2f}s in run_align_sharded; align phase "
        f"{full['seconds']:.2f}s, its run_align "
        f"{full['phases']['run_align']:.2f}s), {n_reads / secs:.1f} "
        f"reads/s, launches {got} (align: {full['launches']['sw_fused']}); "
        "reports byte-identical to align's, counters equal")
    return dict(seconds=secs, run_align_sharded_s=t_align,
                reads_per_s=n_reads / secs, launches=got, counters=mine)


_MULTIHOST_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from sortmerna_tpu_torch.cli import main
from sortmerna_tpu_torch.ops import sw_kernels as K
K.reset_launches()
t = time.perf_counter()
rc = main(sys.argv[2:])
print("RESULT " + json.dumps(dict(rc=rc, seconds=time.perf_counter() - t,
                                  launches=K.LAUNCHES)))
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multihost(top, db, reads, n_reads, wd_full, full):
    """Two processes of the port's CLI joined by gloo on 127.0.0.1
    (SMR_NPROCS=2, SMR_COORD, SMR_PROC_ID 0 and 1), both on cuda:0, each
    with its own workdir and the shared -aligned / -other prefix; process
    0 merges the report sections, which must be byte-identical to the
    align phase's reports.  Everything they load (kernels, native
    library, ALP oracle, index, Gumbel cache) is built already."""
    shared = os.path.join(top, "mh_shared")
    env = dict(os.environ, SMR_TORCH_DEVICE="cuda", SMR_NPROCS="2",
               SMR_COORD=f"127.0.0.1:{free_port()}")
    procs, logs = [], []
    t = time.perf_counter()
    for pid in range(2):
        logs.append(open(os.path.join(OUT_DIR, f"multihost_{pid}.log"),
                         "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST_CHILD, REPO]
            + cli_argv(top, db, reads, os.path.join(top, f"wd_mh{pid}"),
                       ["-aligned", os.path.join(shared, "aligned"),
                        "-other", os.path.join(shared, "other")]),
            env=dict(env, SMR_PROC_ID=str(pid)), stdout=logs[-1],
            stderr=subprocess.STDOUT))
    try:
        # a process that fails leaves the other waiting at a barrier
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t > 600:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    secs = time.perf_counter() - t
    res = []
    for pid, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            raise RuntimeError(f"multihost-align: process {pid} exited "
                               f"{p.returncode}:\n{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(line[-1][len("RESULT "):]))
        if res[-1]["launches"]["sw_fused"] <= 0:
            raise AssertionError(f"multihost-align: process {pid} launched "
                                 f"no sw_fused: {res[-1]['launches']}")
    left = [n for n in os.listdir(shared) if ".s0" in n or ".s1" in n]
    if left:
        raise AssertionError(f"multihost-align: sections left: {left}")
    n_al = same_reports("multihost-align against align", shared,
                        os.path.join(wd_full, "out"))
    log(f"multihost-align: {n_reads} reads over 2 gloo processes on "
        f"cuda:0, {n_al} aligned, {secs:.2f}s for both; "
        + "; ".join(f"process {i}: {r['seconds']:.2f}s (align phase "
                    f"{full['seconds']:.2f}s, "
                    f"{r['seconds'] / full['seconds']:.2f}x), "
                    f"{r['launches']['sw_fused']} sw_fused launches"
                    for i, r in enumerate(res))
        + "; merged reports byte-identical to align's")
    return dict(seconds=secs, processes=res)


def phase_tasks_resume(top, db, reads):
    """2,000 reads on cuda: --task 0, 1, 2 in sequence over one workdir,
    and --task 3 then 2, each giving the reports of --task 4; then a run
    hard-exited right after its 2nd journal unit (a child process:
    journal units of 500 reads), resumed in this process, giving them
    too -- no unit is journaled before its SW waves are fetched."""
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.engine.state import AlignJournal
    sub = os.path.join(top, "reads2k_tasks.fasta")
    head_reads(reads, sub, 2000)
    t = time.perf_counter()
    reset_launches()

    def argv(name, *extra):
        return cli_argv(top, db, sub, os.path.join(top, name), extra)

    run_cli(argv("wd_task4", "-task", "4"), "cuda")
    want = os.path.join(top, "wd_task4", "out")
    for tasks in ((0, 1, 2), (3, 2)):
        name = "wd_task" + "-".join(map(str, tasks))
        for task in tasks:
            run_cli(argv(name, "-task", str(task)), "cuda")
        same_reports(f"tasks {tasks} against task 4",
                     os.path.join(top, name, "out"), want)
    got = launches()
    wd = os.path.join(top, "wd_crash")
    p = subprocess.run([sys.executable, "-c", T.CRASH_CHILD, REPO, "2",
                        "500", "cuda"] + argv("wd_crash"),
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 9:
        raise RuntimeError(f"tasks-and-resume: the crash child exited "
                           f"{p.returncode}:\n{p.stderr[-3000:]}")
    journal = AlignJournal(os.path.join(wd, "kvdb"))
    units = len(list(journal.scan())) - 1
    if journal.meta() != {"batch_size": 500, "n_reads": 2000} \
            or units != 2:
        raise AssertionError(f"tasks-and-resume: journal {journal.meta()} "
                             f"with {units} units after the crash")
    reset_launches()
    run_cli(argv("wd_crash"), "cuda")
    resumed = launches()
    if journal.exists() or resumed["sw_fused"] <= 0:
        raise AssertionError(f"tasks-and-resume: the resume left its "
                             f"journal or launched no sw_fused: {resumed}")
    n_al = same_reports("crash and resume against task 4",
                        os.path.join(wd, "out"), want)
    secs = time.perf_counter() - t
    log(f"tasks-and-resume: 2000 reads on cuda, --task 0,1,2 and 3,2 give "
        f"--task 4's reports ({n_al} aligned); crashed after 2 of 4 "
        f"journal units, resumed: the same reports; {secs:.1f}s; launches "
        f"{got} (task runs), {resumed} (resume)")
    return dict(seconds=secs, launches=got, resume_launches=resumed)


def phase_long_reads(top, mat):
    """Reads of 120, 500 and 2,000 nt and one of 30,000 (MAX_READ_LEN)
    aligned on cpu and on cuda: byte-identical reports, and on cuda the
    long reads' wave blocks (tiles over 1,024 rows) run sw_fused's
    long-tile route inside the align.  Then that route timed with CUDA
    events, beside its bound, for both fused kernels at LONG_TILES."""
    import numpy as np
    import torch
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch import util
    from sortmerna_tpu_torch.ops import sw_kernels as K
    db = os.path.join(top, "long_db.fasta")
    reads = os.path.join(top, "long_reads.fasta")
    T.make_long_reads(db, reads, (120, 500, 2000), 20, longest=30000,
                      seed=2026)
    wds, walls = {}, {}
    for dev in ("cpu", "cuda"):
        wds[dev] = os.path.join(top, f"wd_long_{dev}")
        util.TIMERS.clear()
        reset_launches()
        t = time.perf_counter()
        run_cli(["-ref", db, "-reads", reads] + T.VERIFY_FLAGS
                + ["-idx-dir", os.path.join(top, "idx_long"),
                   "-workdir", wds[dev]], dev)
        walls[dev] = time.perf_counter() - t
        got = launches()
        blocks = sorted(k for k in util.TIMERS if k.startswith("sw_submit["))
        log(f"long-reads: 81 reads (120-30,000 nt) on {dev} in "
            f"{walls[dev]:.2f}s, launches {got}, blocks {blocks}")
        if dev == "cuda":
            tall = [b for b in blocks
                    if int(b.split("[")[1].split("x")[1]) > 1024]
            if got["sw_fused"] <= 0 or not tall:
                raise AssertionError("long-reads: no sw_fused launch on a "
                                     f"tile over 1,024 rows: {blocks}")
            long_launches = got
    n_al = same_reports("long-reads cpu against cuda",
                        os.path.join(wds["cpu"], "out"),
                        os.path.join(wds["cuda"], "out"))
    log(f"long-reads: reports byte-identical on cpu and cuda ({n_al} "
        "aligned)")

    rate = int32_rate()
    res = {}
    # each tile's block from seed 77, as tools/long_ab.py makes it (so the
    # 1 x 32768 x 32768 block is phase_parity_long's, whose plain time it
    # keeps); the call that counts the cells warms up
    for B, lq, lr, iters in LONG_TILES:
        buf = torch.from_numpy(T.long_block(np.random.default_rng(77), B, lq,
                                            lr)).cuda()
        warps, cluster = K.long_geometry(lq)
        route = (f"{cluster} CTA{'s' * (cluster > 1)} of {warps} warps a "
                 "pair" + (" (a cluster)" if cluster > 1 else ""))
        for name in ("sw_fused", "sw_fused2"):
            kernel = getattr(K, name)
            out = kernel(buf, mat, B, lq, lr, 5, 2)
            cells = fused_cells(buf, out, lq, lr)
            ms = cuda_ms(lambda: kernel(buf, mat, B, lq, lr, 5, 2), iters,
                         warmup=0)
            r = dict(ms=ms, cells=cells, route=route, timed_by=f"CUDA "
                     f"events over {iters} launches",
                     **sw_bound(cells, buf.numel() + out.numel() * 4, rate))
            if (name, B, lq, lr) in LONG_PLAIN_MS:
                r["plain_ms"] = LONG_PLAIN_MS[name, B, lq, lr]
            res[f"{name} {B}x{lq}x{lr}"] = r
            log(f"timing {name} {B}x{lq}x{lr} ({route}): {ms:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{r['bound_ms'] / ms:.1%}) over {cells} cells; plain "
                + (f"{r['plain_ms']:.1f} ms" if "plain_ms" in r
                   else "not timed"))
    return dict(launches=long_launches, timing=res, walls=walls)


_HOST_PATH_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from sortmerna_tpu_torch import native
from sortmerna_tpu_torch.cli import main
from sortmerna_tpu_torch.ops import sw_kernels as K
assert not native.have_native()
K.reset_launches()
main(sys.argv[2:])
print("LAUNCHES " + json.dumps(K.LAUNCHES))
"""


def phase_host_path(top, db, reads):
    sub = os.path.join(top, "reads200.fasta")
    head_reads(reads, sub, 200)
    env = dict(os.environ, SMR_NO_NATIVE="1", SMR_TORCH_DEVICE="cuda")
    env.pop("SMR_PALLAS", None)
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", _HOST_PATH_CHILD, REPO]
        + cli_argv(top, db, sub, os.path.join(top, "wd_host")),
        env=env, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError("host-path child failed:\n" + p.stderr[-3000:])
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("LAUNCHES ")][-1]
    got = json.loads(line[len("LAUNCHES "):])
    if got["sw_scan"] <= 0:
        raise AssertionError("the host path launched no sw_scan kernel")
    log(f"host-path: 200 reads in {time.perf_counter() - t:.1f}s, "
        f"launches {got}")
    return got


# ------------------------------------------------------------------ main


REPLACES = {
    "sw_fused": "sortmerna_tpu/ops/sw_pallas.py:54 (_scan_kernel, both "
                "passes of ops/sw_jax.py:233 sw_fused_call)",
    "sw_scan": "sortmerna_tpu/ops/sw_pallas.py:54 (_scan_kernel)",
    "sw_scan2": "sortmerna_tpu/ops/sw_pallas.py:186 (_scan_kernel2, "
                "wrapper sw_scan_pallas2 :306)",
    "sw_fused2": "sortmerna_tpu/ops/sw_pallas.py:186 (_scan_kernel2, both "
                 "passes of ops/sw_jax.py:233 sw_fused_call with "
                 "SMR_PALLAS=2)",
    "seed_probe": "sortmerna_tpu/ops/seed_search.py:204 (_probe_kernel: "
                  "probes, 0-error modes, expansions, per-window sort and "
                  "unique)",
    "seed_compact": "sortmerna_tpu/ops/seed_search.py:331 (_probe_kernel's "
                    "flat compaction)",
}
SOURCES = {"sw_fused": "sw_scan.cu", "sw_scan": "sw_scan.cu",
           "sw_scan2": "sw_scan2.cu", "sw_fused2": "sw_scan2.cu",
           "seed_probe": "seed_probe.cu", "seed_compact": "seed_probe.cu"}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "sortmerna_tpu_torch")):
        print("chip_smoke: sortmerna_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    os.environ["SMR_TIMERS"] = "1"    # the port's stage timers (util.timed)
    for k in ("SMR_PALLAS", "SMR_DEVICE_PROBE"):
        os.environ.pop(k, None)       # the default path unless a phase asks

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from sortmerna_tpu_torch.constants import scoring_matrix_5x5
    mat = torch.as_tensor(scoring_matrix_5x5(2, -3, 0).astype("int32")) \
        .cuda().contiguous()

    ptxas = phase_build()
    # the parity and timing phases are sw_scan2's only launches: no path
    # of the align task calls it (as sw_scan_pallas2 has no caller outside
    # sw_fused_call in the JAX package)
    reset_launches()
    phase_parity(mat)
    timing = phase_timing(mat)
    path_launches = {"sw_scan2": launches()["sw_scan2"]}

    with tempfile.TemporaryDirectory(prefix="smr_chip_",
                                     dir=OUT_DIR) as top:
        db, reads = make_workload(top, N_READS)
        phase_cpu_vs_gpu(top, db, reads)
        timing.update(phase_probe(db, reads))
        wd_full, results = phase_align(top, db, reads, N_READS, "align")
        path_launches["sw_fused"] = results["launches"]["sw_fused"]
        _, v2 = phase_align(
            top, db, reads, N_READS, "pallas2-align",
            env={"SMR_PALLAS": "2"}, path_kernels=("sw_fused2",),
            idle_kernels=("sw_fused",), same_as=wd_full)
        path_launches["sw_fused2"] = v2["launches"]["sw_fused2"]
        phase_cpu_vs_gpu(top, db, reads, extra=["-device_probe"],
                         tag="device-probe",
                         path_kernels=("sw_fused", "seed_probe",
                                       "seed_compact"))
        _, probe = phase_align(
            top, db, reads, N_READS, "device-probe-align",
            extra=["-device_probe"],
            path_kernels=("sw_fused", "seed_probe", "seed_compact"),
            same_as=wd_full)
        for k in ("seed_probe", "seed_compact"):
            path_launches[k] = probe["launches"][k]
        sharded = phase_sharded_align(top, db, reads, N_READS, wd_full,
                                      results)
        sharded_probe = phase_sharded_align(
            top, db, reads, N_READS, wd_full, results,
            tag="sharded-device-probe", extra=["-device_probe"],
            path_kernels=("sw_fused", "seed_probe", "seed_compact"))
        multihost = phase_multihost(top, db, reads, N_READS, wd_full,
                                    results)
        tasks = phase_tasks_resume(top, db, reads)
        long_reads = phase_long_reads(top, mat)
        path_launches["sw_scan"] = phase_host_path(top, db, reads)["sw_scan"]

    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(dict(card=card, ptxas=ptxas, timing=timing,
                       align=results,
                       pallas2_align=v2, device_probe_align=probe,
                       sharded_align=sharded,
                       sharded_device_probe=sharded_probe,
                       multihost_align=multihost,
                       tasks_resume=tasks, long_reads=long_reads,
                       path_launches=path_launches), f, indent=1)
    # the kernels' launches on the paths after the three align runs, and
    # both fused kernels' long-tile route timed at the long-read tiles
    other_paths = {"sw_fused": {
        "sharded-align": sharded["launches"]["sw_fused"],
        "sharded-device-probe": sharded_probe["launches"]["sw_fused"],
        "multihost-align": [r["launches"]["sw_fused"]
                            for r in multihost["processes"]],
        "tasks-and-resume": tasks["launches"]["sw_fused"]
        + tasks["resume_launches"]["sw_fused"],
        "long-reads": long_reads["launches"]["sw_fused"]}}
    for k in ("seed_probe", "seed_compact"):
        other_paths[k] = {
            "sharded-device-probe": sharded_probe["launches"][k]}
    long_tiles = {name: {k.split()[1]: {
        key: v[key] for key in ("route", "ms", "bound_ms", "bound_by",
                                "plain_ms") if key in v}
        for k, v in long_reads["timing"].items() if k.split()[0] == name}
        for name in ("sw_fused", "sw_fused2")}
    kernels = []
    for name in ("sw_fused", "sw_scan", "sw_scan2", "sw_fused2",
                 "seed_probe", "seed_compact"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sortmerna_tpu_torch/csrc/" + SOURCES[name],
            "replaces": REPLACES[name],
            "launches": path_launches[name],
            "launches_in": {"sw_fused": "align", "sw_scan": "host-path",
                            "sw_scan2": "parity and timing (no path "
                                        "calls it)",
                            "sw_fused2": "pallas2-align",
                            "seed_probe": "device-probe-align",
                            "seed_compact": "device-probe-align"}[name],
            "max_abs_err": MAX_ABS_ERR.get(name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call computes SW or the window search;
            # the compaction's is a masked select (timed, never called)
            "library_ms": t.get("library_ms"),
            "timed_by": t["timed_by"],
            **({"eager_ms": t["eager_ms"]} if "eager_ms" in t else {}),
            **({"launches_on_other_paths": other_paths[name]}
               if name in other_paths else {}),
            **({"long_tiles": long_tiles[name]}
               if name in long_tiles else {}),
        })
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
