#!/usr/bin/env python3
"""Time the four SW kernels of two checkouts of the port on one GPU, in
turns, at chip_smoke.py's timing shape.

    python3 sortmerna_tpu_torch/tools/sw_ab.py OLD_CHECKOUT NEW_CHECKOUT

Each checkout's ``sortmerna_tpu_torch`` is built (nvcc, both checkouts at
once) and timed in a child process of its own, in the order old, new,
new, old (``tools/ab.py``), so that drift of the card over the run falls
on both sides.  A child times ``sw_fused`` / ``sw_fused2`` on the packed
block and ``sw_scan`` / ``sw_scan2`` on the scan tiles that
chip_smoke.py's timing phase makes (4096 x 256 x 256, the same seeds),
with CUDA events over 100 launches after 5 warm-up launches.  It prints
the card line, one line a child, and a last JSON line of every time.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab  # noqa: E402

_CHILD = r"""
import numpy as np
import torch
from sortmerna_tpu_torch.constants import scoring_matrix_5x5
from sortmerna_tpu_torch.ops import sw_kernels as K
from sortmerna_tpu_torch.testing import fused_block, scan_tiles
if BUILD:
    K.build(force=True)
    sys.exit(0)
dev = torch.device("cuda")
mat = torch.as_tensor(scoring_matrix_5x5(2, -3, 0).astype("int32")).to(dev)
B, lq, lr = 4096, 256, 256
rng = np.random.default_rng(7)
buf = torch.from_numpy(fused_block(rng, B, lq, lr, False)).to(dev)
Q, rv, R, cv = (torch.from_numpy(a).to(dev)
                for a in scan_tiles(rng, B, lq, lr)[:4])
print(json.dumps({
    "sw_fused": cuda_ms(lambda: K.sw_fused(buf, mat, B, lq, lr, 5, 2),
                        100, 5),
    "sw_fused2": cuda_ms(lambda: K.sw_fused2(buf, mat, B, lq, lr, 5, 2),
                         100, 5),
    "sw_scan": cuda_ms(lambda: K.sw_scan(Q, rv, R, cv, mat, 5, 2, False),
                       100, 5),
    "sw_scan2": cuda_ms(lambda: K.sw_scan2(Q, rv, R, cv, mat, 5, 2, False),
                        100, 5),
}))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(ab.card_line(), flush=True)
    return ab.in_turns("sw_ab", _CHILD, argv, ab.start_builds(_CHILD, argv))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
