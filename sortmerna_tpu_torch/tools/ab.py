"""The shared runner of the A/B timing tools (sw_ab.py, probe_ab.py), and
the device timers that chip_smoke.py uses too.

A tool times checkouts of the port on one GPU in turns: each checkout's
kernels are built at once (one child a checkout, all started together),
then each is timed in a child process of its own, in the order given and
then back (old, new, new, old for two), so that drift of the card over
the run falls on both sides.  The tool gives the child's body: Python
source run with the checkout first on ``sys.path``, ``BUILD`` (true for
the build child), ``ARGS`` (the tool's extra arguments) and the timers of
this module (``cuda_ms``, ``host_ms``) in scope.  A timing child prints
one JSON object of times (float ms) and other facts as its last line.

This module imports nothing of the port, so a child loads it by path
beside any checkout's package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

_PRELUDE = r"""
import importlib.util, json, sys
_spec = importlib.util.spec_from_file_location("smr_ab", {path!r})
_ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ab)
cuda_ms, host_ms = _ab.cuda_ms, _ab.host_ms
sys.path.insert(0, sys.argv[1])
BUILD = sys.argv[2] == "build"
ARGS = sys.argv[3:]
"""


def cuda_ms(fn, iters: int, warmup: int = 2, graph: bool = False) -> float:
    """Device ms a call of ``fn``, CUDA events around ``iters`` calls after
    ``warmup``.  ``graph``: the calls captured in a CUDA graph and
    replayed, so that a launch shorter than its host-side wrapper is timed
    on the device, not on the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    if graph:
        g.replay()
    else:
        for _ in range(iters):
            fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Host-clock ms a call of ``fn`` over ``iters`` calls after ``warmup``,
    the card synchronised before and after."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _argv(body: str, checkout: str, what: str, args) -> list:
    return [sys.executable, "-c", _PRELUDE.format(path=__file__) + body,
            checkout, what, *args]


def start_builds(body: str, checkouts) -> list:
    """One build child a checkout, all started at once."""
    return [subprocess.Popen(_argv(body, c, "build", ())) for c in checkouts]


def in_turns(tool: str, body: str, checkouts, builds, args=(),
             same=()) -> int:
    """Wait for ``builds``, then time each checkout in turns (in order, then
    back), printing a line a child and a last JSON line of every run.  The
    children's values under the keys of ``same`` must agree.  Returns the
    exit code."""
    if any(p.wait(timeout=900) for p in builds):
        print(f"{tool}: a build failed", file=sys.stderr)
        return 1
    runs = []
    for checkout in list(checkouts) + list(checkouts)[::-1]:
        p = subprocess.run(_argv(body, checkout, "time", args),
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append(dict(checkout=checkout, **got))
        print(f"{checkout}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in got.items()
            if isinstance(v, float))
            + "".join(f"; {k} {got[k]}" for k in same), flush=True)
    if len({tuple(r[k] for k in same) for r in runs}) != 1:
        print(f"{tool}: the checkouts' {', '.join(same)} differ",
              file=sys.stderr)
        return 1
    print(json.dumps({"runs": runs}))
    return 0
