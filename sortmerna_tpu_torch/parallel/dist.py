"""Distributed (data-parallel) align orchestration on torch devices and
torch.distributed.

The reference parallelizes one way: N host threads, each owning a
record-aligned byte range of the reads file, sharing the index and
atomic counters (processor.cpp:248-253, readstats.cpp:65-80).  The
equivalents here:

* ``MeshSwBackend`` -- device-level data parallelism: every SW wave block
  is split into contiguous slices over a list of devices, each slice
  fused by the kernel on its own device with that device's copy of the
  scoring matrix; the host sees the same (score, begin, end) arrays as
  the single-device backend.
* ``run_align_sharded`` -- shard-level data parallelism in one process:
  reads are partitioned into contiguous pair-aligned shards
  (mesh.shard_reads), each shard runs the full align sweep in its own
  thread, per-shard Readstats counters are summed (``psum_readstats``),
  and reports are produced from the globally-ordered merged state --
  byte-identical to a single-shard run.
* multi-host runs (``run_all_multihost``): one process a host, joined by
  a gloo process group (``init_multihost``); each process aligns its own
  read shard, the counters are all-reduced on the CPU, and process 0
  merges the per-host report sections.  gloo, not NCCL: what crosses
  processes is a host vector of about ten counters and a few barriers,
  while each process's SW waves run on its own device; and NCCL refuses
  two ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from ..engine.candidates import Readstats
from ..ops.sw_kernels import sw_fused, sw_fused2
from ..ops.sw_torch import TorchSwBackend, resolve_device
from .mesh import make_mesh, shard_reads


def _present(dev: torch.device) -> torch.device:
    """``dev`` as a device of this machine, or raise: a slice never moves
    to another device (the CPU included) on its own."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"sortmerna_tpu_torch: {dev} is not present "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return dev


class MeshSwBackend(TorchSwBackend):
    """TorchSwBackend whose wave blocks are split over ``devices``.

    The fused SW call is independent for each pair, so a block split into
    contiguous slices, one a device, needs no communication: each slice
    is copied to its device and fused there, and the [5, B] results are
    concatenated back on ``devices[0]``, where the block was staged.  The
    kernels take any B, so no slice is padded (the JAX package pads B to
    a multiple of the mesh size with pairs that never pass)."""

    def __init__(self, mat: np.ndarray, gap_open: int, gap_ext: int,
                 devices: Sequence, use_native: bool = True):
        devices = [_present(d) for d in make_mesh(devices=devices)]
        super().__init__(mat, gap_open, gap_ext, device=devices[0],
                         use_native=use_native)
        self.devices = devices
        # each device fuses with its own copy of the scoring matrix
        self.mats = [self.mat.to(d) for d in devices]

    def _device_call(self, buf: torch.Tensor, B: int, lq: int, lr: int):
        fused = sw_fused2 if self.v2 else sw_fused
        outs = []
        for dev, mat, sl in zip(self.devices, self.mats,
                                shard_reads(B, len(self.devices), False)):
            n = sl.stop - sl.start
            if n:
                outs.append(fused(buf[sl].to(dev), mat, n, lq, lr,
                                  self.gap_open, self.gap_ext))
        return torch.cat([o.to(self.device) for o in outs], dim=1)


# ---------------------------------------------------------------------------
# Readstats sums (the std::atomic counters equivalent, readstats.cpp:65-80)

_COUNTER_FIELDS = ("num_aligned", "num_short", "num_denovo",
                   "n_yid_ycov", "n_yid_ncov", "n_nid_ycov")


def _counter_row(rs: Readstats) -> List[int]:
    return [getattr(rs, f) for f in _COUNTER_FIELDS] \
        + list(rs.reads_matched_per_db)


def _set_counters(out: Readstats, tot) -> Readstats:
    tot = [int(x) for x in tot]
    for k, f in enumerate(_COUNTER_FIELDS):
        setattr(out, f, tot[k])
    out.reads_matched_per_db = tot[len(_COUNTER_FIELDS):]
    return out


def psum_readstats(devices: Sequence, shard_stats: List[Readstats],
                   out: Readstats) -> Readstats:
    """Sum per-shard counters into ``out``: each shard's counters are one
    row of an int64 [n_shards, 6 + n_db] matrix, stacked on
    ``devices[0]`` and summed there (one process needs no process
    group)."""
    rows = torch.tensor([_counter_row(rs) for rs in shard_stats],
                        dtype=torch.int64, device=torch.device(devices[0]))
    return _set_counters(out, rows.sum(dim=0).tolist())


def _align_slice(ctx, sl: slice, rs: Readstats, sw_backend, device):
    """Align the reads ``sl`` of ``ctx`` into the private counters ``rs``;
    returns the slice's sub-context (its states are views of the global
    list, so the merged context sees every slice's results)."""
    from ..engine.run import run_align

    sub = dataclasses.replace(
        ctx, reads=ctx.reads[sl], states=ctx.states[sl.start:sl.stop],
        readstats=rs)
    if len(sub.reads):
        run_align(sub, sw_backend=sw_backend, device=device)
    return sub


def run_align_sharded(ctx, devices: Sequence, sw_backend=None,
                      device=None) -> None:
    """Align ``ctx`` as one read shard a device, then sum the stats (the
    multi-host data-parallel layout in one process).

    Shards share the prepared index/refstats (each host replicates the
    index; refstats derive from GLOBAL read totals -- the stats pass is
    global, docs/statistics.rst), own a contiguous pair-aligned read
    slice, and accumulate a private Readstats.  States live in the
    global list so the merged context feeds the normal report path in
    global read order (the deterministic merge, report.cpp:56-96
    semantics).

    Shards execute CONCURRENTLY (one host thread each, like the
    reference's per-thread feed slots, processor.cpp:248-253): every
    shard owns disjoint reads/states/stats, and the shared SW backend is
    called from all shards (each wave's staging buffers belong to its
    own handle), so results are byte-identical regardless of
    interleaving.  Without ``sw_backend`` each shard's run_align makes
    its own backend on ``device`` (default ``devices[0]``)."""
    from concurrent.futures import ThreadPoolExecutor

    devices = make_mesh(devices=devices)
    device = devices[0] if device is None else device
    slices = shard_reads(len(ctx.reads), len(devices), ctx.opts.is_paired)
    shard_stats: List[Readstats] = [
        Readstats(len(ctx.opts.ref_files)) for _ in slices]
    with ThreadPoolExecutor(max_workers=len(slices)) as ex:
        for f in [ex.submit(_align_slice, ctx, sl, rs, sw_backend, device)
                  for sl, rs in zip(slices, shard_stats)]:
            f.result()
    psum_readstats(devices, shard_stats, ctx.readstats)


# ---------------------------------------------------------------------------
# multi-host orchestration (torch.distributed, gloo)


def init_multihost(coordinator: str = None, num_processes: int = None,
                   process_id: int = None) -> tuple:
    """Join the run's process group: ``init_process_group("gloo")`` at
    ``tcp://<coordinator>`` with ``num_processes`` ranks, this one
    ``process_id`` (one process per host, from SMR_COORD, SMR_NPROCS and
    SMR_PROC_ID when not given).  Returns (process_index,
    process_count); a single-process run (SMR_NPROCS unset or 1) joins
    nothing and reports (0, 1).  Raises when a multi-process run lacks
    its coordinator or rank, or the group cannot form."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("SMR_COORD")
    num_processes = num_processes or int(
        os.environ.get("SMR_NPROCS", 0) or 0)
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("SMR_PROC_ID", -1)))
    if num_processes <= 1:
        return 0, 1
    if not coordinator or not 0 <= process_id < num_processes:
        raise SystemExit(
            "ERROR: a multi-host run (SMR_NPROCS=%d) needs SMR_COORD "
            "(host:port of process 0) and SMR_PROC_ID in 0..%d"
            % (num_processes, num_processes - 1))
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _process_count() -> int:
    """The processes of this run: the group's size once joined, else
    SMR_NPROCS."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("SMR_NPROCS", 0) or 0)


def _barrier() -> None:
    """Cross-process sync point: every process of the group arrives."""
    import torch.distributed as dist
    dist.barrier()


def _merge_sections(final_pfx: str, n_hosts: int) -> None:
    """Concatenate per-host report sections into ``<pfx><suffix>`` --
    the split-file merge of report.cpp:56-96.

    Two section shapes exist (written by ``run_reports``):

    * plain ``<pfx>.s{i}<suffix>`` (fastx/other/denovo): each section
      covers one host's contiguous read range; appending in host order
      reproduces the global read order.
    * part-sectioned ``<pfx>.s{i}.g{g:04d}<ext>`` (blast/sam): g
      numbers the (db, part) sweep, g=0 is the host-0-only SAM header
      section.  Merging part-outer/host-inner reproduces the part-outer
      row order a single process writes over all reads
      (output.cpp:196-236).

    No content filtering happens here -- hosts other than the header
    owner never write SAM headers, so raw byte appends are exact (and
    gzip sections concatenate into a valid multi-member stream, as the
    reference's byte-append merge does).  Section files are removed
    after the merge."""
    import glob as _glob
    import re as _re

    sec_re = _re.compile(
        _re.escape(final_pfx) + r"\.s(\d+)(\.g(\d{4}))?((\.|_).*)$")
    plain: dict = {}                 # suffix -> {host: path}
    parts: dict = {}                 # ext -> {(g, host): path}
    for path in _glob.glob(_glob.escape(final_pfx) + ".s*"):
        m = sec_re.match(path)
        if not m:
            continue
        host, gtag, g, suffix = (int(m.group(1)), m.group(2),
                                 m.group(3), m.group(4))
        if suffix.endswith(".otu.json"):
            continue
        if gtag is not None:
            parts.setdefault(suffix, {})[(int(g), host)] = path
        else:
            plain.setdefault(suffix, {})[host] = path

    def _append(out, path):
        with open(path, "rb") as f:
            out.write(f.read())
        os.remove(path)

    for suffix, by_host in sorted(plain.items()):
        with open(final_pfx + suffix, "wb") as out:
            for i in range(n_hosts):
                if i in by_host:
                    _append(out, by_host[i])
    for suffix, by_key in sorted(parts.items()):
        with open(final_pfx + suffix, "wb") as out:
            for key in sorted(by_key):      # (g, host) ascending
                _append(out, by_key[key])


def _merge_otu_sections(final_pfx: str, n_hosts: int) -> dict:
    """Merge the per-host OTU maps part-outer/host-inner: each host's
    section holds one map for each (index, part) sweep, in sweep order,
    and replaying them part by part, hosts in order within a part,
    inserts every reference group and appends every read exactly as a
    single process sweeping the parts over all reads does
    (otumap.cpp:192-281).  (The JAX package merges whole per-host maps
    host-major, which orders the groups differently once a host's reads
    reach several index parts.)"""
    import json as _json
    sections = []
    for i in range(n_hosts):
        sec = f"{final_pfx}.s{i}.otu.json"
        if not os.path.exists(sec):
            continue
        with open(sec) as f:
            sections.append(_json.load(f))
        os.remove(sec)
    merged: dict = {}
    for g in range(max((len(s) for s in sections), default=0)):
        for parts in sections:
            for ref, read_ids in (parts[g] if g < len(parts) else ()):
                merged.setdefault(ref, []).extend(read_ids)
    return merged


def run_all_multihost(opts, sw_backend=None, device=None):
    """Full multi-host run: each process aligns + postprocesses its own
    contiguous pair-aligned read shard, writes its reports as section
    files, counters all-reduce over every process, and process 0 merges
    the sections into the final reports + writes the summary --
    byte-identical to a single-process run over the same reads.

    Trigger from the CLI: SMR_COORD/SMR_NPROCS/SMR_PROC_ID in the env
    (cli.py main).  Each process needs its own workdir (kvdb/readb are
    per-process) but a SHARED -aligned/-other prefix on a common
    filesystem for the sections to merge.  ``device`` is where this
    process's SW waves run (default ``cuda``); processes may share a GPU.

    Ordering: blast/sam sections are written per (host, index part) and
    merged part-outer/host-inner, matching the part-outer row order a
    single process writes over all reads (output.cpp:169-272) -- byte
    parity holds for multi-part and multi-DB sweeps, not just the
    single-part case.
    """
    from ..engine.run import prepare, run_postprocess, run_reports
    from ..engine.postprocess import write_otu_map
    from ..reports.summary import write_summary

    opts.finalize()
    if opts.task != 4 and _process_count() > 1:
        # refused before the group forms: no rank waits for this one
        raise SystemExit(
            "ERROR: --task splitting is a single-host workflow (the "
            "per-task state store is per-process); multi-host runs "
            "execute the full pipeline (--task 4).")
    pidx, pcount = init_multihost()
    if pcount <= 1:
        from ..engine.run import run_all
        return run_all(opts, sw_backend=sw_backend, device=device)
    if sw_backend is None:
        device = resolve_device(device)   # fail before any host work

    ctx = prepare(opts)
    mine = shard_reads(len(ctx.reads), pcount, opts.is_paired)[pidx]
    local_rs = Readstats(len(opts.ref_files))
    sub = _align_slice(ctx, mine, local_rs, sw_backend, device)
    otu_parts: list = []                # this shard's map of each part
    otu_map = run_postprocess(sub, otu_parts)  # shard denovo/otu counters

    # one all-reduce covers align AND postprocess counters
    psum_readstats_multihost(local_rs, ctx.readstats)

    # per-host report sections over this host's slice
    import copy as _copy
    import json as _json
    sopts = _copy.copy(opts)
    sopts.aligned_pfx = opts.aligned_pfx + f".s{pidx}"
    if opts.is_other:
        sopts.other_pfx = opts.other_pfx + f".s{pidx}"
    rsub = dataclasses.replace(sub, opts=sopts, readstats=ctx.readstats)
    out_dir = os.path.dirname(opts.aligned_pfx) or "."
    os.makedirs(out_dir, exist_ok=True)
    run_reports(rsub, otu_map, part_sections=True,
                sam_header_out=(pidx == 0))
    if opts.is_otu_map:
        with open(opts.aligned_pfx + f".s{pidx}.otu.json", "w") as f:
            _json.dump([list(m.items()) for m in otu_parts], f)

    _barrier()                          # every section is on disk
    if pidx == 0:
        _merge_sections(opts.aligned_pfx, pcount)
        if opts.is_other:
            _merge_sections(opts.other_pfx, pcount)
        merged_otu = _merge_otu_sections(opts.aligned_pfx, pcount)
        if opts.is_otu_map:
            ctx.readstats.total_otu = len(merged_otu)
            write_otu_map(merged_otu,
                          os.path.join(out_dir, "otu_map.txt"))
        write_summary(opts, ctx.refstats, ctx.readstats,
                      len(merged_otu))
    _barrier()                          # merge visible everywhere
    return ctx


def psum_readstats_multihost(local: Readstats, out: Readstats) -> None:
    """All-reduce (SUM) one host's counters over every process: an int64
    vector on the CPU, which the gloo group reduces; with no group the
    local counters are the totals."""
    import torch.distributed as dist
    vec = torch.tensor(_counter_row(local), dtype=torch.int64)
    if dist.is_initialized():
        dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    _set_counters(out, vec.tolist())
