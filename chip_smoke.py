#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sortmerna_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, and no result line is
printed):

1. card: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: the SW kernels (csrc/sw_scan.cu, nvcc for sm_90a), the native
   host library and the ALP oracle, compiled from this checkout in
   parallel;
3. parity: every kernel against its plain PyTorch version on the card,
   bit-exact (int32 equality);
4. timing: each kernel at the main path's shape (4096 x 256 x 256) with
   CUDA events, beside its plain version and its bound;
5. cpu-vs-gpu: the first 2,000 reads aligned by the port's CLI on
   ``cpu`` (plain versions) and on ``cuda``; the reports must be
   byte-identical;
6. align: the align task at full size through ``sortmerna_tpu_torch.cli``
   on ``cuda`` -- a synthetic 16S-like database of 4,000 sequences of
   1,300-1,600 nt (about 6 Mnt, 40 families, members about 8% apart) and
   100,000 reads of 100-150 nt (half cut from the database with 0-3
   substitutions and occasional 1-2 nt indels, half random); the
   ``sw_fused`` launch count must be > 0.  It also reports the kernels'
   device time on that run (CUDA events around each launch) and the
   port's host stage timers (``util.timed``);
7. host-path: the python traverse (native library switched off with
   SMR_NO_NATIVE=1, in a child process) on 200 reads, whose SW jobs go
   through ``TorchSwBackend.batch`` -> the ``sw_scan`` kernel.

Before the last line it prints the card line and one JSON line with the
kernels (launches on their path, ms, plain ms, bound); the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Details go to
chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import os
import shutil
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
# and the next column's E; the column max one.  The same count stands in
# the note of csrc/sw_scan.cu.
OPS_PER_CELL = 6
INT32_LANES_PER_SM = 64      # CUDA programming guide, cc 9.0 throughput
N_READS = 100000             # reads of the align phase
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


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
    """Bit-exact (int32 equality) or raise; records the max |got - want|
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


# ---------------------------------------------------------------- phases


def phase_build():
    from sortmerna_tpu_torch import native
    from sortmerna_tpu_torch.ops import sw_kernels
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
        ("sw_kernels (nvcc)", lambda: sw_kernels.build(force=True)),
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
    sw_kernels.load()
    shutil.copy(sw_kernels.BUILD_LOG, os.path.join(OUT_DIR, "ptxas.txt"))
    log("build: " + ", ".join(f"{k} {v:.1f}s" for k, v in done.items())
        + "; ptxas report in chiprun_out/chip_smoke/ptxas.txt")


def phase_parity(mat):
    import numpy as np
    import torch
    from sortmerna_tpu_torch.ops import sw_kernels as K
    from sortmerna_tpu_torch.testing import fused_block
    rng = np.random.default_rng(123)
    dev = torch.device("cuda")
    for (B, Lq, Lr) in ((4096, 256, 256), (64, 4096, 256)):
        Q, rv, R, cv, _, _ = scan_inputs(rng, B, Lq, Lr, dev)
        for term in (False, True):
            ts = None
            if term:      # stop at the forward best: the begin-pass regime
                ts = K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, False,
                                     None)[0]
            got = K.sw_scan(Q, rv, R, cv, mat, 5, 2, term, ts)
            torch.cuda.synchronize()
            want = K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, term, ts)
            equal_or_raise(f"sw_scan {B}x{Lq}x{Lr} terminate={term}",
                           got, want)
            log(f"parity sw_scan {B}x{Lq}x{Lr} terminate={term}: "
                "bit-exact")
    for (B, lq, lr) in ((4096, 256, 256), (64, 2048, 2048)):
        buf = torch.from_numpy(fused_block(rng, B, lq, lr)).to(dev)
        got = K.sw_fused(buf, mat, B, lq, lr, 5, 2)
        torch.cuda.synchronize()
        want = K.sw_fused_plain(buf, mat, B, lq, lr, 5, 2)
        equal_or_raise(f"sw_fused {B}x{lq}x{lr}", got, want)
        n_pass = int((got[1] >= 0).sum())
        log(f"parity sw_fused {B}x{lq}x{lr}: bit-exact "
            f"({n_pass}/{B} pairs pass to the begin pass)")


def phase_timing(mat):
    import numpy as np
    import torch
    from sortmerna_tpu_torch.ops import sw_kernels as K
    from sortmerna_tpu_torch.testing import fused_block
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    int32_rate = props.multi_processor_count * INT32_LANES_PER_SM \
        * max_sm_clock_hz()
    B, lq, lr = 4096, 256, 256
    res = {}

    # sw_fused at the main path's block shape
    buf = torch.from_numpy(fused_block(rng, B, lq, lr, False)).to(dev)
    out = K.sw_fused(buf, mat, B, lq, lr, 5, 2)
    ms = cuda_ms(lambda: K.sw_fused(buf, mat, B, lq, lr, 5, 2), 20)
    plain_ms = cuda_ms(lambda: K.sw_fused_plain(buf, mat, B, lq, lr, 5, 2),
                       2, warmup=1)
    o = out.cpu().numpy().astype(np.int64)
    ints = buf[:, lq // 2 + lr // 2:].cpu().numpy().view("<i4")
    ql = ints[:, 0].clip(0, lq).astype(np.int64)
    rl = ints[:, 1].clip(0, lr).astype(np.int64)
    ok = o[1] >= 0
    # forward: every valid cell; begin pass: rows up to end_read, columns
    # from end_ref back to beg_ref (where it terminates)
    cells = int((ql * rl).sum()
                + ((o[4][ok] + 1) * (o[2][ok] - o[1][ok] + 1)).sum())
    nbytes = buf.numel() + out.numel() * 4
    res["sw_fused"] = dict(ms=ms, plain_ms=plain_ms, cells=cells,
                           bound_ms=max(cells * OPS_PER_CELL / int32_rate,
                                        nbytes / HBM_BYTES_PER_S) * 1e3,
                           bound_by="operations")

    # sw_scan (forward, no terminate) at the same tile shape
    Q, rv, R, cv, qlen, rlen = scan_inputs(rng, B, lq, lr, dev)
    ms = cuda_ms(lambda: K.sw_scan(Q, rv, R, cv, mat, 5, 2, False), 20)
    plain_ms = cuda_ms(lambda: K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2,
                                               False, None), 2, warmup=1)
    cells = int((qlen.astype(np.int64) * rlen).sum())
    nbytes = (Q.numel() + R.numel()) * 4 + rv.numel() + cv.numel() + 3 * B * 4
    res["sw_scan"] = dict(ms=ms, plain_ms=plain_ms, cells=cells,
                          bound_ms=max(cells * OPS_PER_CELL / int32_rate,
                                       nbytes / HBM_BYTES_PER_S) * 1e3,
                          bound_by="operations")
    for k, v in res.items():
        log(f"timing {k} {B}x{lq}x{lr}: {v['ms']:.4f} ms (plain "
            f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.4f} ms over "
            f"{v['cells']} cells at {int32_rate / 1e12:.2f} int32 Top/s)")
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


def head_reads(src, dst, n):
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 2 * n:
                break
            g.write(line)


def phase_cpu_vs_gpu(top, db, reads):
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import sw_kernels as K
    sub = os.path.join(top, "reads2k.fasta")
    head_reads(reads, sub, 2000)
    outs = {}
    for dev in ("cpu", "cuda"):
        wd = os.path.join(top, f"wd2k_{dev}")
        t = time.perf_counter()
        K.reset_launches()
        run_cli(["-ref", db, "-reads", sub] + T.VERIFY_FLAGS
                + ["-idx-dir", os.path.join(top, "idx"), "-workdir", wd],
                dev)
        log(f"cpu-vs-gpu: 2000 reads on {dev} in "
            f"{time.perf_counter() - t:.1f}s, launches {dict(K.LAUNCHES)}")
        outs[dev] = T.read_outputs(os.path.join(wd, "out"))
    if outs["cpu"] != outs["cuda"]:
        bad = [k for k in outs["cpu"] if outs["cpu"][k] != outs["cuda"].get(k)]
        raise AssertionError(f"cpu and cuda reports differ: {bad}")
    n_al = outs["cuda"]["aligned.fa"].count(b">")
    log(f"cpu-vs-gpu: {len(outs['cpu'])} reports byte-identical "
        f"({n_al} aligned reads in aligned.fa)")


def phase_align(top, db, reads, n_reads):
    import torch
    from sortmerna_tpu_torch import native, util
    import glob
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.ops import sw_kernels as K
    from sortmerna_tpu_torch.ops import sw_torch
    wd = os.path.join(top, "wd_full")
    # device time of the path: a pair of CUDA events around each sw_fused
    # launch (the H2D copy is queued before the first, the D2H after the
    # second, so each pair spans the kernel alone)
    events = []
    launch = sw_torch.sw_fused

    def evented(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    # host clock around the task's phases as run_all calls them
    from sortmerna_tpu_torch.engine import run as run_mod
    phase_s = {}
    phases = {n: getattr(run_mod, n) for n in
              ("prepare", "run_align", "run_postprocess", "run_reports")}

    def clocked(name, fn):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                phase_s[name] = phase_s.get(name, 0.0) \
                    + time.perf_counter() - t0
        return inner

    sw_torch.sw_fused = evented
    for n, fn in phases.items():
        setattr(run_mod, n, clocked(n, fn))
    util.TIMERS.clear()
    K.reset_launches()
    t = time.perf_counter()
    try:
        run_cli(["-ref", db, "-reads", reads] + T.VERIFY_FLAGS
                + ["-idx-dir", os.path.join(top, "idx"), "-workdir", wd],
                "cuda")
    finally:
        sw_torch.sw_fused = launch
        for n, fn in phases.items():
            setattr(run_mod, n, fn)
    secs = time.perf_counter() - t
    phase_s["other"] = secs - sum(phase_s.values())
    launches = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    stages = sorted(((k, v[0], v[1]) for k, v in util.TIMERS.items()),
                    key=lambda r: -r[1])
    with open(os.path.join(OUT_DIR, "align_stages.txt"), "w") as f:
        f.write(f"wall {secs:.3f}s; sw_fused kernel time {kernel_s:.3f}s "
                f"over {len(events)} launches\nrun_all phases: "
                + ", ".join(f"{k} {v:.3f}s" for k, v in phase_s.items())
                + "\nstage timers (util.timed, nested):\n")
        f.writelines(f"{k:32s} {s:9.3f}s x{n}\n" for k, s, n in stages)
    if launches["sw_fused"] <= 0:
        raise AssertionError("the align task launched no sw_fused kernel")
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
    log(f"align: {n_reads} reads, {aligned} aligned (Gumbel provider alp), "
        f"{secs:.2f}s, {n_reads / secs:.1f} reads/s, launches {launches}")
    log(f"align: sw_fused kernels busy {kernel_s:.3f}s of {secs:.2f}s "
        f"({100 * kernel_s / secs:.2f}%); phases "
        + ", ".join(f"{k} {v:.2f}s" for k, v in phase_s.items())
        + "; host stages "
        + ", ".join(f"{k} {s:.2f}s" for k, s, _ in stages[:6])
        + " (all in chiprun_out/chip_smoke/align_stages.txt)")
    return dict(reads=n_reads, aligned=aligned, gumbel_provider="alp",
                seconds=secs,
                reads_per_s=n_reads / secs, launches=launches,
                kernel_seconds=kernel_s, phases=phase_s,
                stages={k: [s, n] for k, s, n in stages})


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
    from sortmerna_tpu_torch import testing as T
    sub = os.path.join(top, "reads200.fasta")
    head_reads(reads, sub, 200)
    env = dict(os.environ, SMR_NO_NATIVE="1", SMR_TORCH_DEVICE="cuda")
    wd = os.path.join(top, "wd_host")
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", _HOST_PATH_CHILD, REPO, "-ref", db,
         "-reads", sub] + T.VERIFY_FLAGS
        + ["-idx-dir", os.path.join(top, "idx"), "-workdir", wd],
        env=env, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError("host-path child failed:\n" + p.stderr[-3000:])
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("LAUNCHES ")][-1]
    launches = json.loads(line[len("LAUNCHES "):])
    if launches["sw_scan"] <= 0:
        raise AssertionError("the host path launched no sw_scan kernel")
    log(f"host-path: 200 reads in {time.perf_counter() - t:.1f}s, "
        f"launches {launches}")
    return launches


# ------------------------------------------------------------------ main


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

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from sortmerna_tpu_torch.constants import scoring_matrix_5x5
    from sortmerna_tpu_torch.ops import sw_kernels as K
    mat = torch.as_tensor(scoring_matrix_5x5(2, -3, 0).astype("int32")) \
        .cuda().contiguous()

    phase_build()
    phase_parity(mat)
    timing = phase_timing(mat)

    with tempfile.TemporaryDirectory(prefix="smr_chip_",
                                     dir=OUT_DIR) as top:
        db, reads = make_workload(top, N_READS)
        phase_cpu_vs_gpu(top, db, reads)
        results = phase_align(top, db, reads, N_READS)
        path_launches = {
            "sw_fused": results["launches"]["sw_fused"],
            "sw_scan": phase_host_path(top, db, reads)["sw_scan"]}

    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(dict(card=card, timing=timing, align=results,
                       path_launches=path_launches), f, indent=1)
    replaces = {
        "sw_fused": "sortmerna_tpu/ops/sw_pallas.py:54 (_scan_kernel, "
                    "both passes of ops/sw_jax.py:233 sw_fused_call)",
        "sw_scan": "sortmerna_tpu/ops/sw_pallas.py:54 (_scan_kernel)",
    }
    kernels = []
    for name in ("sw_fused", "sw_scan"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sortmerna_tpu_torch/csrc/sw_scan.cu",
            "replaces": replaces[name],
            "launches": path_launches[name],
            "max_abs_err": MAX_ABS_ERR.get(name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,    # no single PyTorch call computes SW
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
