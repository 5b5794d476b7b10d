"""End-to-end run orchestration (main.cpp:59-115 task graph).

Pipeline: load reads -> readstats -> build/load indexes -> refstats ->
align (index x part sweep over batches) -> denovo stats -> otu map ->
summary -> reports.

The reference streams reads per thread from byte-range feed slots
(readfeed.cpp); this engine loads reads in batches and keeps the per-read
alignment state in memory (spilled to the state store for task-split
resume, engine/state.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import scoring_matrix_5x5
from ..index.builder import BuiltIndex, build_index
from ..io.fastx import iter_fastx
from ..options import RunOptions
from ..stats.refstats import Refstats, compute_refstats
from .align import align_part, load_part_refs
from .candidates import Opts, PartContext, Readstats
from .read import ReadSeq, ReadState


@dataclass
class RunContext:
    opts: RunOptions
    reads: List[ReadSeq]            # or io.feed.LazyReads
    states: List[ReadState]
    readstats: Readstats
    indexes: List[BuiltIndex]
    refstats: Refstats
    engine_opts: Opts
    feed: object = None             # io.feed.ReadFeed when streaming
    _tmp: object = None             # holds a TemporaryDirectory alive


def prepare(opts: RunOptions) -> RunContext:
    opts.finalize()
    from ..io.feed import LazyReads, ReadFeed
    tmp = None
    readb = opts.readb_dir
    if not readb:
        import tempfile
        tmp = tempfile.TemporaryDirectory(prefix="smr_readb_")
        readb = tmp.name
    feed = ReadFeed(opts.reads_files, readb,
                    threads=max(1, opts.num_proc_thread))
    reads = LazyReads(feed)
    readstats = Readstats(len(opts.ref_files))
    readstats.all_reads_count = feed.n
    readstats.all_reads_len = feed.total_len
    readstats.min_read_len = feed.min_len
    readstats.max_read_len = feed.max_len

    from ..index.artifact import build_or_load
    indexes = [build_or_load(p, opts.idx_dir or None, opts.interval,
                             opts.max_pos, opts.max_file_size,
                             seed_win_len=opts.seed_win_len)
               for p in opts.ref_files]

    refstats = compute_refstats(
        indexes, readstats.all_reads_count, readstats.all_reads_len,
        opts.evalue, opts.match, opts.mismatch, opts.gap_open, opts.gap_ext,
        gumbel_override=opts.gumbel_override,
        cache_dir=opts.idx_dir or None)

    states = [ReadState() for _ in range(len(reads))]
    for st in states:
        if opts.min_lis > 0:
            st.best = opts.min_lis       # read.cpp:267

    eopts = Opts(
        num_alignments=opts.num_alignments,
        is_best=opts.is_best,
        num_seeds=opts.num_seeds,
        min_lis=opts.min_lis,
        edges=opts.edges,
        is_as_percent=opts.is_as_percent,
        match=opts.match,
        mismatch=opts.mismatch,
        gap_open=opts.gap_open,
        gap_ext=opts.gap_ext,
        score_n=opts.score_n,
        is_full_search=opts.is_full_search,
        is_forward=opts.is_forward,
        is_reverse=opts.is_reverse,
        minoccur=opts.minoccur,
        threads=max(1, opts.num_proc_thread),
        device_probe=bool(opts.device_probe
                          or os.environ.get("SMR_DEVICE_PROBE")),
    )
    return RunContext(opts, reads, states, readstats, indexes, refstats,
                      eopts, feed=feed, _tmp=tmp)


def run_align(ctx: RunContext, sw_backend=None, batch_size: int = 100000,
              journal=None, device=None) -> None:
    """The align task (processor.cpp:173-285).

    When ``journal`` (state.AlignJournal) is given, every completed
    (index, part, batch) unit is checkpointed so a killed run resumes
    where it stopped (processor.cpp:117-126,154 semantics).  Without
    ``sw_backend`` the SW waves run on a TorchSwBackend on ``device``
    (default ``cuda``; see ops/sw_torch.resolve_device)."""
    opts = ctx.opts
    done_units = set()
    if journal is not None and journal.exists():
        meta = journal.meta() or {}
        if meta.get("n_reads") != len(ctx.reads):
            raise SystemExit(
                "align journal in %r was written for a different input "
                "(%s reads vs %d); clear the KVDB directory to start "
                "fresh" % (os.path.dirname(journal.path),
                           meta.get("n_reads"), len(ctx.reads)))
        batch_size = meta["batch_size"]   # unit keys must line up
        done_units = journal.restore(ctx.states, ctx.readstats)
    if sw_backend is None:
        from ..ops.sw_torch import TorchSwBackend
        mat = scoring_matrix_5x5(opts.match, opts.mismatch, opts.score_n)
        sw_backend = TorchSwBackend(mat, opts.gap_open, opts.gap_ext,
                                    device=device)

    from .read import ReadBatch

    n_reads = len(ctx.reads)

    def make_batch(b0: int) -> ReadBatch:
        hi = min(b0 + batch_size, n_reads)
        # LazyReads views (incl. shard slices) translate to global feed
        # coordinates themselves
        ps = getattr(ctx.reads, "packed_slice", None)
        if ps is not None:
            return ReadBatch.from_packed(*ps(b0, hi))
        return ReadBatch(ctx.reads[b0:hi])

    if journal is not None:
        journal.begin(batch_size, n_reads)

    # batches are cached across parts/strands when they fit comfortably;
    # larger runs stream (re-packing per part is cheap vs align time)
    starts = list(range(0, n_reads, batch_size))
    cache_all = n_reads <= batch_size * 2
    packed_cache = {b0: make_batch(b0) for b0 in starts} if cache_all \
        else None

    def iter_batches():
        for b0 in starts:
            yield b0, (packed_cache[b0] if cache_all else make_batch(b0))

    n_idx = len(ctx.indexes)
    for idx_num, built in enumerate(ctx.indexes):
        skips = opts.skiplengths[idx_num]
        for part_num, part in enumerate(built.parts):
            ref_seqs, ref_headers = load_part_refs(
                opts.ref_files[idx_num], part.first_seq, part.numseq_part,
                start_byte=part.start_part)
            pctx = PartContext(
                index_num=idx_num,
                part_num=part_num,
                pos_offsets=part.pos_offsets,
                pos_seq=part.pos_seq,
                pos_pos=part.pos_pos,
                ref_seqs=ref_seqs,
                minimal_score=ctx.refstats.minimal_score[idx_num],
                lnwin=ctx.refstats.lnwin[idx_num],
                is_last_index=(idx_num == n_idx - 1),
                is_last_part=(part_num == len(built.parts) - 1),
            )
            for b0, rbatch in iter_batches():
                if (idx_num, part_num, b0) in done_units:
                    continue
                batch = ctx.reads[b0:b0 + batch_size]
                bstates = ctx.states[b0:b0 + batch_size]
                # too-short accounting (processor.cpp:109-114)
                ctx.readstats.num_short += int(
                    (rbatch.lens < pctx.lnwin).sum())
                # first unit of a non-resumed run: states are still the
                # prepare() defaults, so the part driver can synthesize
                # its import arrays without walking the objects
                fresh = (idx_num == 0 and part_num == 0
                         and not done_units)
                from ..util import timed as _t
                with _t("align_part"):
                    align_part(batch, bstates, part, pctx,
                               ctx.engine_opts, skips, sw_backend,
                               ctx.readstats, batch=rbatch,
                               states_fresh=fresh)
                if journal is not None:
                    journal.append(idx_num, part_num, b0, bstates,
                                   ctx.readstats)
    from ..util import timed as _t2
    with _t2("cigar_mat"):
        materialize_cigars(ctx)


def materialize_cigars(ctx: RunContext) -> None:
    """Batched traceback for SURVIVING alignments with deferred CIGARs.

    The native engine defers CIGAR generation (replace-min churn of
    best-N bookkeeping, alignment.cpp:420-459, makes eager tracebacks
    ~3x the surviving count).  A pending alignment's ``tb`` is either a
    ``(WinStore, action_index)`` handle into a part-export's window
    buffers (the fast path: pointer arrays into those buffers are
    computed vectorized, zero window bytes copied) or a legacy
    ``(ref_window, read_window, band)`` view triple."""
    materialize_cigars_for(ctx.states, ctx.opts)


def materialize_cigars_for(states, opts) -> None:
    """materialize_cigars over an explicit read-state subset.

    Also called per slice by the grouped overlap scheduler on the LAST
    (index, part) -- slots there can no longer be replaced, so each
    slice's tracebacks run as soon as its waves finish and overlap the
    other slices' device time instead of draining serially afterward."""
    pend = [a for st in states for a in st.alignments
            if a.cigar is None and a.tb is not None]
    if not pend:
        return
    mat = scoring_matrix_5x5(opts.match, opts.mismatch,
                             opts.score_n).astype(np.int64)
    from .. import native
    from ..ops import sw_ref
    handles = [a for a in pend if len(a.tb) == 2]
    legacy = [a for a in pend if len(a.tb) == 3]
    if native.have_native():
        if handles:
            groups: dict = {}
            for a in handles:
                store, i = a.tb
                g = groups.get(id(store))
                if g is None:
                    g = groups[id(store)] = (store, [], [])
                g[1].append(i)
                g[2].append(a)
            rp_l, rl_l, qp_l, ql_l, sc_l, bd_l, alns = \
                [], [], [], [], [], [], []
            for store, idxs, aa in groups.values():
                idx = np.asarray(idxs, np.int64)
                r_lo = store.r_out[idx]
                q_lo = store.q_out[idx]
                rp_l.append(store.rbuf.ctypes.data
                            + r_lo.astype(np.uint64))
                rl_l.append((store.r_out[idx + 1] - r_lo)
                            .astype(np.int32))
                qp_l.append(store.qsrc.ctypes.data
                            + q_lo.astype(np.uint64))
                ql_l.append((store.q_out[idx + 1] - q_lo)
                            .astype(np.int32))
                bd_l.append(store.bands[idx])
                sc_l.append(np.fromiter((a.score1 for a in aa),
                                        np.int32, count=len(aa)))
                alns.extend(aa)
            cigs = native.traceback_ptrs(
                np.concatenate(rp_l), np.concatenate(rl_l),
                np.concatenate(qp_l), np.concatenate(ql_l),
                np.concatenate(sc_l), np.concatenate(bd_l),
                opts.gap_open, opts.gap_ext, mat)
            for a, cg in zip(alns, cigs):
                a.cigar = cg
                a.tb = None
        if legacy:
            cigs = native.traceback_batch(
                [a.tb[0] for a in legacy], [a.tb[1] for a in legacy],
                [a.score1 for a in legacy], [a.tb[2] for a in legacy],
                opts.gap_open, opts.gap_ext, mat)
            for a, cg in zip(legacy, cigs):
                a.cigar = cg
                a.tb = None
    else:
        for a in pend:
            rw, qw, band = a.tb if len(a.tb) == 3 else \
                a.tb[0].window(a.tb[1])
            a.cigar = list(sw_ref.banded_sw_traceback(
                rw.astype(np.int64), qw.astype(np.int64),
                a.score1, opts.gap_open, opts.gap_ext, band, mat))
            a.tb = None


def part_ref_context(ctx: RunContext, idx_num: int, part_num: int):
    """(ref_seqs, ref_headers) for a report pass.

    The denovo, otu and blast/sam passes all sweep the same parts in
    order (output.cpp:196-219), so one part stays cached and repeat
    requests skip the fasta re-read (memory stays bounded to one part).
    """
    key = (idx_num, part_num)
    cached = getattr(ctx, "_part_ref_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    part = ctx.indexes[idx_num].parts[part_num]
    val = load_part_refs(ctx.opts.ref_files[idx_num], part.first_seq,
                         part.numseq_part, start_byte=part.start_part)
    ctx._part_ref_cache = (key, val)
    return val


# ---------------------------------------------------------------------------
# post-processing + reports (main.cpp:83-112 task graph)


def _report_reads(ctx: RunContext):
    """Reads view for the postprocess/report sweeps: memoized (one
    ReadSeq + its encodings per ordinal, shared across all sweeps) up
    to SMR_REPORT_CACHE_MAX reads (default 2M, ~1KB each); beyond that
    the streaming LazyReads view is kept to bound memory."""
    cached = getattr(ctx, "_report_reads", None)
    if cached is not None:
        return cached
    cap = int(os.environ.get("SMR_REPORT_CACHE_MAX", "2000000"))
    reads = ctx.reads
    if not isinstance(reads, list) and len(reads) <= cap:
        from ..io.feed import CachedReads
        reads = CachedReads(reads)
    ctx._report_reads = reads
    return reads


def run_postprocess(ctx: RunContext) -> Dict[str, list]:
    """denovo_stats + fill_otu_map (processor.cpp:368-438,
    otumap.cpp:192-281).  Returns the OTU map."""
    from .postprocess import denovo_stats_part, fill_otu_map_part

    opts = ctx.opts
    otu_map: Dict[str, list] = {}
    if not (opts.is_otu_map or opts.is_denovo):
        return otu_map
    reads = _report_reads(ctx)
    from ..reports.cigar_stats import precompute_part_stats
    for idx_num, built in enumerate(ctx.indexes):
        for part_num in range(len(built.parts)):
            ref_seqs, ref_headers = part_ref_context(ctx, idx_num, part_num)
            precompute_part_stats(ctx, idx_num, part_num, ref_seqs)
            denovo_stats_part(reads, ctx.states, ref_seqs, idx_num,
                              part_num, opts.min_id, opts.min_cov,
                              ctx.readstats)
    if opts.is_otu_map and ctx.readstats.n_yid_ycov > 0:
        for idx_num, built in enumerate(ctx.indexes):
            for part_num in range(len(built.parts)):
                ref_seqs, ref_headers = part_ref_context(
                    ctx, idx_num, part_num)
                fill_otu_map_part(reads, ctx.states, ref_seqs,
                                  ref_headers, idx_num, part_num,
                                  opts.min_id, opts.min_cov, otu_map)
        ctx.readstats.total_otu = len(otu_map)
    return otu_map


def _pairs(ctx: RunContext):
    """Iterate reads in report order: pairs when paired, else singles."""
    reads = _report_reads(ctx)
    step = 2 if ctx.opts.is_paired else 1
    for i in range(0, len(reads), step):
        yield (reads[i:i + step], ctx.states[i:i + step])


def run_reports(ctx: RunContext, otu_map: Dict[str, list], *,
                part_sections: bool = False,
                sam_header_out: bool = True) -> None:
    """writeReports equivalent (output.cpp:80-272).

    With ``part_sections=True`` (multi-host report shards) blast/sam
    rows are written to one file per global index part --
    ``<pfx>.g{g:04d}.blast[.gz]`` with g numbering the (db, part) sweep
    order -- and the SAM header goes to a ``.g0000.sam`` section (only
    when ``sam_header_out``; one host owns it).  The multi-host merger
    concatenates sections part-outer/host-inner, reproducing the
    part-outer row order a single process writes over all reads
    (output.cpp:196-236, report.cpp:56-96).
    """
    from ..reports.blast import blast_for_read
    from ..reports.fastx import DenovoReport, FastxReport
    from ..reports.sam import sam_for_read, sam_header
    from ..reports.summary import write_summary
    from .postprocess import write_otu_map

    opts = ctx.opts
    out_dir = os.path.dirname(opts.aligned_pfx) or "."
    os.makedirs(out_dir, exist_ok=True)
    orig_fastq = [r.is_fastq for r in
                  (ctx.reads[:2] if opts.is_paired else ctx.reads[:1])] \
        or [False]

    fastx = other = denovo = None
    if opts.is_fastx:
        fastx = FastxReport(opts, opts.aligned_pfx, orig_fastq, other=False)
    if opts.is_other:
        other = FastxReport(opts, opts.other_pfx, orig_fastq, other=True)
    if opts.is_denovo:
        denovo = DenovoReport(opts, opts.aligned_pfx + "_denovo",
                              orig_fastq, other=False)

    blast_f = sam_f = None
    gz = opts.zip_out == 1
    import gzip as _gzip
    op = (lambda p: _gzip.open(p + ".gz", "wt")) if gz else \
        (lambda p: open(p, "wt"))

    def _write_sam_header(f):
        f.write(sam_header(
            opts, [[(m.header, m.length) for m in ix.stats.sam_sq]
                   for ix in ctx.indexes] if opts.is_SQ else []))

    if not part_sections:
        if opts.is_blast:
            blast_f = op(opts.aligned_pfx + ".blast")
        if opts.is_sam:
            sam_f = op(opts.aligned_pfx + ".sam")
            _write_sam_header(sam_f)
    elif opts.is_sam and sam_header_out:
        hf = op(opts.aligned_pfx + ".g0000.sam")
        _write_sam_header(hf)
        hf.close()

    # single pass for fastx/other/denovo (output.cpp:126-144, 234-236)
    if fastx or other or denovo:
        from ..reports.fastx import is_denovo_read
        for reads, states in _pairs(ctx):
            if fastx:
                fastx.append(reads, states)
            if other:
                other.append(reads, states)
            if denovo:
                if any(is_denovo_read(s) for s in states):
                    denovo.append_denovo(reads, states)
        for rep in (fastx, other, denovo):
            if rep:
                rep.close()

    # per-part passes for blast/sam (output.cpp:146-149)
    if opts.is_blast or opts.is_sam:
        reads = _report_reads(ctx)
        from ..reports.cigar_stats import precompute_part_stats
        g = 0
        for idx_num, built in enumerate(ctx.indexes):
            for part_num in range(len(built.parts)):
                g += 1
                if part_sections:
                    if opts.is_blast:
                        blast_f = op(
                            opts.aligned_pfx + f".g{g:04d}.blast")
                    if opts.is_sam:
                        sam_f = op(opts.aligned_pfx + f".g{g:04d}.sam")
                ref_seqs, ref_headers = part_ref_context(
                    ctx, idx_num, part_num)
                precompute_part_stats(ctx, idx_num, part_num, ref_seqs)
                for read, st in zip(reads, ctx.states):
                    if blast_f:
                        blast_f.write(blast_for_read(
                            read, st.alignments, ref_headers, ref_seqs,
                            ctx.refstats, idx_num, part_num,
                            opts.blast_format, opts.blastops,
                            opts.is_print_all_reads))
                    if sam_f:
                        sam_f.write(sam_for_read(
                            read, st.alignments, ref_headers, ref_seqs,
                            idx_num, part_num, opts.is_print_all_reads))
                if part_sections:
                    for f in (blast_f, sam_f):
                        if f:
                            f.close()
                    blast_f = sam_f = None
        for f in (blast_f, sam_f):
            if f:
                f.close()

def run_all(opts: RunOptions, sw_backend=None,
            batch_size: int = 100000, device=None) -> RunContext:
    """Full task dispatch (main.cpp:83-112).

    ``device`` names where the SW waves run: ``cuda`` (the default)
    launches the hand-written kernels and raises when no GPU is present;
    ``cpu`` runs their plain PyTorch versions."""
    from ..ops.sw_torch import resolve_device
    from ..reports.summary import write_summary
    from .state import AlignJournal, StateDB, readfiles_key

    if sw_backend is None:
        device = resolve_device(device)   # fail before any host work
    ctx = prepare(opts)
    task = opts.task
    otu_map: Dict[str, list] = {}

    db = StateDB(opts.kvdb_dir) if opts.kvdb_dir else None
    journal = AlignJournal(opts.kvdb_dir) if opts.kvdb_dir else None

    if db is not None and task in (0, 3, 4) and not db.is_empty() \
            and not (journal and journal.exists()):
        # finished state present and no in-flight journal: a fresh align
        # would silently mix runs -- refuse like the reference
        # (options.cpp:1313-1326 validate_kvdbdir)
        raise SystemExit(
            "KVDB directory %r is not empty. Please ensure it is empty "
            "prior to running an alignment task (an interrupted run "
            "with its journal present resumes automatically)."
            % opts.kvdb_dir)

    def read_ids():
        if hasattr(ctx.reads, "ids"):    # no ReadSeq materialization
            return ctx.reads.ids()
        return [r.id for r in ctx.reads]

    if db is not None and task in (1, 2):
        # restore states from a previous align task
        saved = db.load_states()
        for i, rid in enumerate(read_ids()):
            st = saved.get(rid)
            if st is not None:
                ctx.states[i] = st
        stats = db.load_readstats(readfiles_key(opts.reads_files))
        if stats:
            for k, v in stats.items():
                if hasattr(ctx.readstats, k):
                    setattr(ctx.readstats, k, v)

    if task in (0, 3, 4):
        run_align(ctx, sw_backend=sw_backend, journal=journal,
                  batch_size=batch_size, device=device)
        if db is not None:
            db.save_states(read_ids(), ctx.states)
            db.save_readstats(readfiles_key(opts.reads_files),
                              ctx.readstats)
            journal.remove()    # subsumed by the consolidated state

    if task in (1, 3, 4):
        otu_map = run_postprocess(ctx)
        if opts.is_otu_map:
            from .postprocess import write_otu_map
            out_dir = os.path.dirname(opts.aligned_pfx) or "."
            os.makedirs(out_dir, exist_ok=True)
            write_otu_map(otu_map, os.path.join(out_dir, "otu_map.txt"))
        if db is not None:
            db.save_states(read_ids(), ctx.states)
            db.save_readstats(readfiles_key(opts.reads_files),
                              ctx.readstats)
        write_summary(opts, ctx.refstats, ctx.readstats, len(otu_map))

    if task in (2, 4):
        run_reports(ctx, otu_map)
    return ctx
