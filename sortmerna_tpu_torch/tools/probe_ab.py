#!/usr/bin/env python3
"""Time the seed probe kernels of two checkouts of the port on one GPU, in
turns, on chip_smoke.py's probe batch.

    python3 sortmerna_tpu_torch/tools/probe_ab.py OLD_CHECKOUT NEW_CHECKOUT \
        [MORE_CHECKOUTS ...]

The workload is chip_smoke.py's: the synthetic 16S-like database (4,000
sequences, seed 2024), its index part 0 built once by this checkout's
builder, and 65,536 windows cut from the reads (seed 2025, the first
reads of the 100,000) as chip_smoke.py's probe phase cuts them.  Each
checkout's ``csrc/seed_probe.cu`` is built (nvcc, all at once) and timed
in a child process of its own, in the order given and then back (old,
new, new, old for two; ``tools/ab.py``), so that drift of the card over
the run falls on both sides.  A child times, on the same tables and
windows (full_search off, minoccur 0), into the searcher's persistent
buffers as the search does:

* ``seed_probe``: the kernel alone, CUDA events over 100 launches after 5
  warm-up launches;
* ``seed_compact``: the kernel alone (its scan of the counts included),
  100 launches captured in a CUDA graph and replayed (its launches are
  shorter than the wrapper's host time); ``seed_compact_eager`` the same
  from CUDA events over 100 eager launches;
* ``compaction``: from the counts to a total on the host (the launch and
  the read of the total), host clock over 100 rounds;
* ``search``: ``DeviceSeedSearcher.search_windows`` on the numpy windows
  (copies in and out included), host clock over 20 calls.

The children's (window, id) pairs must agree (a digest of each).  It
prints the card line, one line a child, and a last JSON line of every
time.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_WINDOWS = 65536
PART_FIELDS = ("f_exact_keys", "f_exact_vals", "f_pref_keys",
               "f_pref_start", "f_pref_count", "r_exact_keys",
               "r_exact_start", "r_exact_count", "r_exact_zero",
               "r_pref_keys", "r_pref_start", "r_pref_count", "k19_keys",
               "k19_vals", "r_ids", "kmer_counts")

_CHILD = r"""
import hashlib, types
import numpy as np
import torch
from sortmerna_tpu_torch.ops import seed_search as S
from sortmerna_tpu_torch.ops import sw_kernels
if BUILD:
    sw_kernels.build_one("seed_probe", force=True)
    sys.exit(0)
z = np.load(ARGS[0])
part = types.SimpleNamespace(**{k: z[k] for k in z.files
                                if k not in ("w1", "w2", "L")})
part.seed_win_len = int(z["L"])
pw = part.seed_win_len // 2
dev = torch.device("cuda")
searcher = S.DeviceSeedSearcher(part, 0, False, device=dev)
tabs = searcher.tabs
w1n, w2n = z["w1"], z["w2"]
w1 = torch.from_numpy(w1n).to(dev, torch.int32)
w2 = torch.from_numpy(w2n).to(dev, torch.int32)
bufs = searcher._buffers(len(w1n))
probe = lambda: S.seed_probe(tabs, w1, w2, pw, False, 0, out=bufs["probe"])
count, ids = probe()
compact = lambda: S.seed_compact(count, ids, pw, out=bufs["compact"])
got = searcher.search_windows(w1n, w2n)
digest = hashlib.sha256(got[0].tobytes() + got[1].tobytes()).hexdigest()
print(json.dumps({
    "seed_probe": cuda_ms(probe, 100, 5),
    "seed_compact": cuda_ms(compact, 100, 5, graph=True),
    "seed_compact_eager": cuda_ms(compact, 100, 5),
    "compaction": host_ms(lambda: int(compact()[2][0]), 100),
    "search": host_ms(lambda: searcher.search_windows(w1n, w2n), 20),
    "pairs": int(len(got[0])), "digest": digest[:16],
}))
"""


def make_batch(path: str, top: str) -> None:
    """chip_smoke.py's probe batch: index part 0 and the windows, saved."""
    import numpy as np
    sys.path.insert(0, REPO)
    from sortmerna_tpu_torch import testing as T
    from sortmerna_tpu_torch.index.builder import build_index
    db = os.path.join(top, "db16s.fasta")
    reads = os.path.join(top, "reads.fasta")
    t = time.perf_counter()
    seqs = T.make_db(db, 4000, n_families=40, len_range=(1300, 1600),
                     divergence=0.08, seed=2024)
    T.make_reads(reads, seqs, 8000, len_range=(100, 150), seed=2025)
    part = build_index(db).parts[0]
    L = getattr(part, "seed_win_len", 18)
    w1, w2 = T.read_windows(reads, L, N_WINDOWS, seed=11)
    np.savez(path, w1=w1, w2=w2, L=L,
             **{k: getattr(part, k) for k in PART_FIELDS})
    print(f"batch: index part 0 and {N_WINDOWS} windows in "
          f"{time.perf_counter() - t:.1f}s", flush=True)


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(ab.card_line(), flush=True)
    builds = ab.start_builds(_CHILD, argv)
    with tempfile.TemporaryDirectory(prefix="probe_ab_") as top:
        batch = os.path.join(top, "batch.npz")
        make_batch(batch, top)
        return ab.in_turns("probe_ab", _CHILD, argv, builds, args=(batch,),
                           same=("pairs", "digest"))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
