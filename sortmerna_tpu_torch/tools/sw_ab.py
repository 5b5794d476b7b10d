#!/usr/bin/env python3
"""Time the four SW kernels of two checkouts of the port on one GPU, in
turns, at chip_smoke.py's timing shape.

    python3 sortmerna_tpu_torch/tools/sw_ab.py OLD_CHECKOUT NEW_CHECKOUT

Each checkout's ``sortmerna_tpu_torch`` is built (nvcc, both checkouts at
once) and timed in a child process of its own, in the order old, new,
new, old, so that drift of the card over the run falls on both sides.  A
child times ``sw_fused`` / ``sw_fused2`` on the packed block and
``sw_scan`` / ``sw_scan2`` on the scan tiles that chip_smoke.py's timing
phase makes (4096 x 256 x 256, the same seeds), with CUDA events over 100
launches after 5 warm-up launches.  It prints the card line, one line a
child, and a last JSON line of every time.
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from sortmerna_tpu_torch.constants import scoring_matrix_5x5
from sortmerna_tpu_torch.ops import sw_kernels as K
from sortmerna_tpu_torch.testing import fused_block, scan_tiles
if sys.argv[2] == "build":
    K.build(force=True)
    sys.exit(0)
dev = torch.device("cuda")
mat = torch.as_tensor(scoring_matrix_5x5(2, -3, 0).astype("int32")).to(dev)
B, lq, lr = 4096, 256, 256
rng = np.random.default_rng(7)
buf = torch.from_numpy(fused_block(rng, B, lq, lr, False)).to(dev)
Q, rv, R, cv = (torch.from_numpy(a).to(dev)
                for a in scan_tiles(rng, B, lq, lr)[:4])

def ms(fn, iters=100, warmup=5):
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

print(json.dumps({
    "sw_fused": ms(lambda: K.sw_fused(buf, mat, B, lq, lr, 5, 2)),
    "sw_fused2": ms(lambda: K.sw_fused2(buf, mat, B, lq, lr, 5, 2)),
    "sw_scan": ms(lambda: K.sw_scan(Q, rv, R, cv, mat, 5, 2, False)),
    "sw_scan2": ms(lambda: K.sw_scan2(Q, rv, R, cv, mat, 5, 2, False)),
}))
"""


def child(checkout: str, what: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _CHILD, checkout, what],
                          capture_output=True, text=True, timeout=600)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, "-c", _CHILD, c, "build"])
              for c in (old, new)]
    if any(p.wait(timeout=900) for p in builds):
        print("sw_ab: a build failed", file=sys.stderr)
        return 1
    runs = []
    for tag, checkout in (("old", old), ("new", new), ("new", new),
                          ("old", old)):
        p = child(checkout, "time")
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        times = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append(dict(side=tag, **times))
        print(f"{tag}: " + ", ".join(f"{k} {v:.4f} ms"
                                     for k, v in times.items()), flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
