#!/usr/bin/env python3
"""Time the fused SW kernels of two checkouts of the port on one GPU, in
turns, at the long-read tiles (more than 1,024 query rows).

    python3 sortmerna_tpu_torch/tools/long_ab.py OLD_CHECKOUT NEW_CHECKOUT

Each checkout's ``sortmerna_tpu_torch`` is built (nvcc, both checkouts at
once) and timed in a child process of its own, in the order old, new,
new, old (``tools/ab.py``).  A child times ``sw_fused`` at each tile of
``TILES`` (and ``sw_fused2`` where listed) on a block of long true
matches (``testing.long_block``, seed 77, the same bytes for every
checkout), with CUDA events over the tile's launch count after one
untimed launch, and prints a digest of the outputs: the checkouts must
agree on it.  It prints the card line, one line a child, and a last JSON
line of every time.
"""

from __future__ import annotations

import inspect
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))
import ab  # noqa: E402
from sortmerna_tpu_torch.testing import long_block  # noqa: E402

# (B, lq, lr, timed launches, kernels): the long-read buckets' blocks as
# TorchSwBackend forms them (64 rows a block from 8,192 on), and one
# 30,000-nt read alone (its latency)
TILES = ((1024, 2048, 2048, 10, ("sw_fused", "sw_fused2")),
         (256, 4096, 4096, 5, ("sw_fused",)),
         (64, 8192, 8192, 3, ("sw_fused",)),
         (64, 32768, 32768, 1, ("sw_fused",)),
         (1, 32768, 32768, 1, ("sw_fused",)))

_CHILD = r"""
import hashlib
import numpy as np
import torch
from sortmerna_tpu_torch.constants import scoring_matrix_5x5
from sortmerna_tpu_torch.ops import sw_kernels as K
from sortmerna_tpu_torch.testing import pack_block
""" + inspect.getsource(long_block) + f"""
TILES = {TILES!r}
""" + r"""
if BUILD:
    K.build(force=True)
    sys.exit(0)
dev = torch.device("cuda")
mat = torch.as_tensor(scoring_matrix_5x5(2, -3, 0).astype("int32")).to(dev)
res, digest = {}, hashlib.sha256()
for B, lq, lr, iters, names in TILES:
    buf = torch.from_numpy(long_block(np.random.default_rng(77), B, lq,
                                      lr)).to(dev)
    for name in names:
        fn = getattr(K, name)
        digest.update(fn(buf, mat, B, lq, lr, 5, 2).cpu().numpy().tobytes())
        res[f"{name} {B}x{lq}x{lr}"] = cuda_ms(
            lambda: fn(buf, mat, B, lq, lr, 5, 2), iters, 0)
res["digest"] = digest.hexdigest()[:16]
print(json.dumps(res))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(ab.card_line(), flush=True)
    return ab.in_turns("long_ab", _CHILD, argv,
                       ab.start_builds(_CHILD, argv), same=("digest",))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
