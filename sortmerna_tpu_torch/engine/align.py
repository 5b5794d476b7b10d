"""Alignment task driver: batched multi-pass seed search + SW waves.

Port of the reference control flow (processor.cpp `align`/`align2`,
paralleltraversal.cpp `traverse`) restructured for batch execution:

* reference: per-thread loop over reads, per read a sequential multi-pass
  window search with inline trie traversal and inline SSW.
* here: all reads of a batch advance through the SAME pass together; each
  pass issues ONE bulk seed-probe (device-friendly), then all reads whose
  seed count reached the threshold run their candidate coroutines, whose
  SW jobs are executed in batched waves (engine/candidates.py).

Per-read semantics (pass scheduling, skiplengths, hit accumulation,
is_done conditions) follow paralleltraversal.cpp:95-297 exactly.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import NT_TABLE, PARTIAL_WIN, SEED_WIN_LEN, scoring_matrix_5x5
from ..index.builder import BuiltIndex, IndexPart
from ..ops.seed_probe import SeedSearcher
from .candidates import (Opts, PartContext, Readstats, SwJob,
                         compute_lis_alignment)
from .read import ReadSeq, ReadState


# ---------------------------------------------------------------------------
# per-read traversal state


@dataclass
class _TravState:
    win_shift: int
    pass_n: int = 0
    search: bool = True
    hits: List[Tuple[int, int]] = field(default_factory=list)
    np_hits: List[Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=list)
    searched: Optional[np.ndarray] = None


def pack9_all(seq03: np.ndarray, pw: int = PARTIAL_WIN) -> np.ndarray:
    """Packed pw-mers at every start position 0..len-pw (MSB first)."""
    n = len(seq03) - pw + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    arr = np.ascontiguousarray(seq03, dtype=np.int64)
    acc = np.zeros(n, dtype=np.int64)
    for k in range(pw):
        np.left_shift(acc, 2, out=acc)
        np.add(acc, arr[k:k + n], out=acc)
    return acc


def run_candidate_waves(gens: List[Tuple[int, object]], backend
                        ) -> Dict[int, bool]:
    """Drive candidate coroutines in SW waves.

    gens: list of (read_ordinal, generator).  Returns {ordinal: search}.
    """
    search_flags: Dict[int, bool] = {}
    active: List[Tuple[int, object, SwJob]] = []
    for ordn, gen in gens:
        try:
            job = gen.send(None)
            active.append((ordn, gen, job))
        except StopIteration as e:
            search_flags[ordn] = e.value
    while active:
        results = backend.batch([job for (_, _, job) in active])
        nxt = []
        for (ordn, gen, _), res in zip(active, results):
            try:
                job = gen.send(res)
                nxt.append((ordn, gen, job))
            except StopIteration as e:
                search_flags[ordn] = e.value
        active = nxt
    return search_flags


# the check-and-build of a part's cached device searcher (read shards
# reach it from several threads at once)
_SEARCHER_LOCK = threading.Lock()


def _make_searcher(part, opts: Opts, device=None):
    """SeedSearcher for this part; the device prober when requested
    (--device_probe / SMR_DEVICE_PROBE) on ``device`` (the SW backend's),
    cached on the part so its tables go to the device once per part and
    are reused across strands, batches and read shards.  A part whose
    group sizes exceed the prober's caps takes the host prober, with a
    warning; any other failure of the device prober raises."""
    if getattr(opts, "device_probe", False):
        from ..ops.seed_search import DeviceSeedSearcher, ProbeCapsExceeded
        key = (opts.minoccur, opts.is_full_search, str(device))
        with _SEARCHER_LOCK:
            cached = getattr(part, "_dev_searcher", None)
            if cached is not None and cached[0] == key:
                return cached[1]
            try:
                s = DeviceSeedSearcher(part, opts.minoccur,
                                       opts.is_full_search, device=device)
            except ProbeCapsExceeded as e:
                from ..util import WARN
                WARN(f"device probe unavailable ({e}); using host prober")
            else:
                part._dev_searcher = (key, s)
                return s
    return SeedSearcher(part, opts.minoccur, opts.is_full_search,
                        threads=opts.threads)


def traverse_strand(
    reads: List[ReadSeq],
    states: List[ReadState],
    ordinals: List[int],
    forward: bool,
    searcher: SeedSearcher,
    ctx: PartContext,
    opts: Opts,
    skiplengths: Sequence[int],
    backend,
    readstats: Readstats,
    is_last_strand: bool,
    native_engine=None,
    batch: Optional["ReadBatch"] = None,
) -> None:
    """One strand of one index part for a batch of reads
    (traverse, paralleltraversal.cpp:81-297).

    Vectorized over reads: window enumeration, packing and hit
    attribution happen as bulk array ops over a concatenated per-strand
    buffer; the per-read pass scheduling stays scalar (cheap)."""
    if batch is None:
        from .read import ReadBatch
        batch = ReadBatch(reads)
    if native_engine is not None:
        return _traverse_strand_vec(
            reads, states, ordinals, forward, searcher, ctx, opts,
            skiplengths, backend, readstats, is_last_strand,
            native_engine, batch)
    lnwin = ctx.lnwin
    trav: Dict[int, _TravState] = {}

    # concatenated 03 sequences + packed 9-mers at every position
    n_all = len(reads)
    offs = batch.offs
    lens = batch.lens
    from ..util import timed as _t
    with _t("batch_enc03"):
        concat = batch.concat03(forward)
    pw = lnwin // 2
    with _t("pack9"):
        p9all = pack9_all(concat, pw)  # invalid at read boundaries; only
    #                                in-read window starts are indexed
    searched = np.zeros(offs[-1], dtype=bool)

    for i in ordinals:
        states[i].last_index = ctx.index_num
        states[i].last_part = ctx.part_num
        trav[i] = _TravState(win_shift=skiplengths[0])

    from ..util import timed
    live = [i for i in ordinals]
    while live:
        # ---- collect this pass's unsearched windows (bulk)
      with timed("trav_enum"):
        la = np.asarray(live, dtype=np.int64)
        shifts = np.asarray([trav[i].win_shift for i in live],
                            dtype=np.int64)
        numwin = (lens[la] - lnwin + shifts) // shifts
        total = int(numwin.sum())
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(numwin) - numwin, numwin))
        rd = np.repeat(la, numwin)
        pos = within * np.repeat(shifts, numwin)
        gidx = offs[rd] + pos
        fresh = ~searched[gidx]
        searched[gidx] = True
        probe_read = rd[fresh]
        probe_pos = pos[fresh]
        gsel = gidx[fresh]

      if True:
        if len(probe_read):
            w1 = p9all[gsel]
            w2 = p9all[gsel + pw]
            with timed("probe"):
                hw, hid = searcher.search_windows(w1, w2)
            # attribute hits; one hit_seeds increment per window with
            # >=1 id (paralleltraversal.cpp:242-249)
            if len(hw):
              with timed("trav_group"):
                hit_read = probe_read[hw]
                hit_pos = probe_pos[hw]
                # distinct windows per read
                uniq_w = np.unique(hw)
                seeds_per_read = np.bincount(
                    probe_read[uniq_w], minlength=n_all)
                for i in np.flatnonzero(seeds_per_read):
                    states[i].hit_seeds += int(seeds_per_read[i])
                # group (kid, win) pairs per read; hw is nondecreasing so
                # hits are read-contiguous
                change = np.ones(len(hit_read), dtype=bool)
                change[1:] = hit_read[1:] != hit_read[:-1]
                starts = np.flatnonzero(change)
                bounds = np.append(starts, len(hit_read))
                for s0, s1 in zip(bounds[:-1], bounds[1:]):
                    i = int(hit_read[s0])
                    trav[i].np_hits.append(
                        (hid[s0:s1], hit_pos[s0:s1]))

        # ---- LIS/SW stage for reads whose seed count reaches threshold
        for i in live:
            t = trav[i]
            for kid_arr, win_arr in t.np_hits:
                t.hits.extend(zip(kid_arr.tolist(), win_arr.tolist()))
            t.np_hits = []
        gens = []
        for i in live:
            if states[i].hit_seeds >= opts.num_seeds:
                max_sw = len(reads[i]) * opts.match
                gens.append((i, compute_lis_alignment(
                    reads[i], states[i], trav[i].hits, forward, ctx,
                    opts, readstats, max_sw)))
        flags = run_candidate_waves(gens, backend)
        for i, sflag in flags.items():
            trav[i].search = sflag

        # ---- pass advance (paralleltraversal.cpp:259-283)
      with timed("trav_adv"):
        nxt_live = []
        for i in live:
            t = trav[i]
            if t.search:
                if t.pass_n == 2:
                    t.search = False
                else:
                    while (t.pass_n < 3
                           and skiplengths[t.pass_n]
                           == skiplengths[min(t.pass_n + 1, 2)]
                           and t.pass_n + 1 <= 2):
                        t.pass_n += 1
                    t.pass_n += 1
                    if t.pass_n > 2:
                        t.search = False
                    else:
                        t.win_shift = skiplengths[t.pass_n]
            if t.search:
                nxt_live.append(i)
        live = nxt_live

    _apply_done(states, ordinals, opts, ctx, is_last_strand)


def _apply_done(states, ordinals, opts, ctx, is_last_strand) -> None:
    """Done conditions (paralleltraversal.cpp:285-297)."""
    for i in ordinals:
        st = states[i]
        if opts.num_alignments > 0:
            if ((opts.is_best and opts.num_alignments == st.max_sw_count)
                    or (not opts.is_best
                        and len(st.alignments) == opts.num_alignments)):
                st.is_done = True
        else:
            if (ctx.is_last_index and ctx.is_last_part and is_last_strand
                    and len(st.alignments) > 0):
                st.is_done = True


def _traverse_strand_vec(
    reads: List[ReadSeq],
    states: List[ReadState],
    ordinals: List[int],
    forward: bool,
    searcher: SeedSearcher,
    ctx: PartContext,
    opts: Opts,
    skiplengths: Sequence[int],
    backend,
    readstats: Readstats,
    is_last_strand: bool,
    native_engine,
    batch: "ReadBatch",
) -> None:
    """Native-engine traverse with ALL per-read bookkeeping as arrays.

    Same per-read semantics as the scalar path
    (paralleltraversal.cpp:95-297): the pass scheduler becomes a table
    lookup over pass_n (the transition depends only on the shared
    skiplengths), hit accumulation merges per-pass (read, kid, win)
    triples with one stable sort, and eligible reads' packed hit lists
    slice out via searchsorted + repeat/arange."""
    from ..util import timed
    lnwin = ctx.lnwin
    n_all = batch.n
    offs = batch.offs
    lens = batch.lens
    with timed("batch_enc03"):
        concat = batch.concat03(forward)
    pw = lnwin // 2
    with timed("pack9"):
        p9all = pack9_all(concat, pw)
    searched = np.zeros(offs[-1], dtype=bool)

    la = np.asarray(ordinals, dtype=np.int64)
    for i in ordinals:
        states[i].last_index = ctx.index_num
        states[i].last_part = ctx.part_num

    # scheduler state over ordinals
    pass_n = np.zeros(n_all, dtype=np.int64)
    win_shift = np.full(n_all, skiplengths[0], dtype=np.int64)
    hs0 = np.zeros(n_all, dtype=np.int64)
    if len(ordinals):
        hs0[la] = np.fromiter((states[i].hit_seeds for i in ordinals),
                              np.int64, count=len(ordinals))
    hs = hs0.copy()

    # pass transition tables (paralleltraversal.cpp:259-283): next pass
    # and survives-to-next-pass, as functions of the current pass
    next_tab = np.zeros(4, np.int64)
    alive_tab = np.zeros(4, bool)
    for p in range(3):
        q = p
        if q == 2:
            next_tab[p], alive_tab[p] = 3, False
            continue
        while (q < 3 and skiplengths[q] == skiplengths[min(q + 1, 2)]
               and q + 1 <= 2):
            q += 1
        q += 1
        next_tab[p], alive_tab[p] = q, q <= 2
    shift_tab = np.asarray(list(skiplengths[:3]) + [skiplengths[2]],
                           np.int64)

    # accumulated hits so far, sorted by read (stable across passes)
    m_read = m_kid = m_win = None
    while len(la):
        # ---- this pass's unsearched windows (bulk)
        with timed("trav_enum"):
            shifts = win_shift[la]
            numwin = (lens[la] - lnwin + shifts) // shifts
            total = int(numwin.sum())
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(np.cumsum(numwin) - numwin, numwin))
            rd = np.repeat(la, numwin)
            pos = within * np.repeat(shifts, numwin)
            gidx = offs[rd] + pos
            fresh = ~searched[gidx]
            searched[gidx] = True
            probe_read = rd[fresh]
            probe_pos = pos[fresh]
            gsel = gidx[fresh]

        if len(probe_read):
            w1 = p9all[gsel]
            w2 = p9all[gsel + pw]
            with timed("probe"):
                hw, hid = searcher.search_windows(w1, w2)
            if len(hw):
                with timed("trav_group"):
                    # one hit_seeds increment per distinct window with
                    # >=1 id (paralleltraversal.cpp:242-249)
                    hs += np.bincount(probe_read[np.unique(hw)],
                                      minlength=n_all)
                    hit_read = probe_read[hw]
                    hit_pos = probe_pos[hw]
                    if m_read is None:
                        m_read, m_kid, m_win = hit_read, hid, hit_pos
                    else:
                        # both runs are already read-sorted (la ascending,
                        # window/probe order preserved), so a stable merge
                        # of two sorted runs replaces the full argsort;
                        # existing hits sort before new ones on ties
                        total = len(m_read) + len(hit_read)
                        pos_old = (np.arange(len(m_read), dtype=np.int64)
                                   + np.searchsorted(hit_read, m_read,
                                                     "left"))
                        pos_new = (np.arange(len(hit_read), dtype=np.int64)
                                   + np.searchsorted(m_read, hit_read,
                                                     "right"))
                        nr = np.empty(total, m_read.dtype)
                        nk = np.empty(total, m_kid.dtype)
                        nw = np.empty(total, m_win.dtype)
                        nr[pos_old] = m_read
                        nr[pos_new] = hit_read
                        nk[pos_old] = m_kid
                        nk[pos_new] = hid
                        nw[pos_old] = m_win
                        nw[pos_new] = hit_pos
                        m_read, m_kid, m_win = nr, nk, nw

        # ---- LIS/SW for reads at the seed threshold: slice their
        # accumulated hits out of the merged triples in packed form
        with timed("trav_items"):
            elig = la[hs[la] >= opts.num_seeds]
            if len(elig):
                if m_read is not None:
                    s0 = np.searchsorted(m_read, elig, "left")
                    s1 = np.searchsorted(m_read, elig, "right")
                    cnt = s1 - s0
                    hit_off = np.zeros(len(elig) + 1, np.int64)
                    np.cumsum(cnt, out=hit_off[1:])
                    gather = (np.arange(int(hit_off[-1]), dtype=np.int64)
                              - np.repeat(hit_off[:-1], cnt)
                              + np.repeat(s0, cnt))
                    kids_all = np.ascontiguousarray(m_kid[gather],
                                                    np.int64)
                    wins_all = np.ascontiguousarray(m_win[gather],
                                                    np.int64)
                else:
                    hit_off = np.zeros(len(elig) + 1, np.int64)
                    kids_all = np.zeros(1, np.int64)
                    wins_all = np.zeros(1, np.int64)
        sflags = None
        if len(elig):
            sflags = native_engine.run_pass_packed(
                elig.astype(np.int32), hit_off, kids_all, wins_all,
                states, backend, readstats)

        # ---- pass advance (paralleltraversal.cpp:259-283)
        with timed("trav_adv"):
            keep = np.ones(len(la), bool)
            if sflags is not None:
                stop = elig[~np.asarray(sflags, bool)]
                if len(stop):
                    # la is ascending by construction (ordinals ascending,
                    # boolean filters preserve order) and elig slices out
                    # of it, so searchsorted maps stop -> positions in la
                    keep[np.searchsorted(la, stop)] = False
            la2 = la[keep]
            p = pass_n[la2]
            pass_n[la2] = next_tab[p]
            la = la2[alive_tab[p]]
            win_shift[la] = shift_tab[pass_n[la]]

    # write back hit_seeds for reads that gained seeds this strand
    changed = np.flatnonzero(hs != hs0)
    for i in changed.tolist():
        states[i].hit_seeds = int(hs[i])

    _apply_done(states, ordinals, opts, ctx, is_last_strand)


# batches at or above this size split into read-range slices whose
# host stages and device waves pipeline against each other
OVERLAP_MIN_READS = 8192

# read-range slices a part's batch is cut into, by the SW backend's
# device type: the card has device time to hide behind the host stages
# and gains from fine slicing; on the host extra waves are pure overhead
OVERLAP_SLICES = {"cuda": 24, "cpu": 2}


def _run_part_overlapped(part, ctx, opts, batch, states, skiplengths,
                         backend, readstats, states_fresh) -> None:
    """Pipelined part sweep: the batch splits into read-range slices
    (independent reads, shared concat buffers), one native driver each.
    Two halves of the slices take turns: one half's pumps (probe, FSM
    start, result application) run at once on the native pool of
    ``-threads`` workers while the other half's SW waves are on the
    device.  A half's waves concatenate, across both strands, into one
    device call a strand buffer.  Results are byte-identical to the
    single-driver sweep: reads never interact within a part, and each
    slice keeps its own in-order pass sequence.
    """
    from .part_driver import NativePartDriver

    dev = getattr(backend, "device", None)
    k = OVERLAP_SLICES["cuda" if getattr(dev, "type", "cpu") == "cuda"
                       else "cpu"]
    cuts = [batch.n * i // k for i in range(k + 1)]
    spans = [(cuts[i], cuts[i + 1]) for i in range(k)
             if cuts[i] < cuts[i + 1]]
    k = len(spans)
    finished = [False] * k      # slices exported as their pumps ran dry
    drvs = [NativePartDriver(part, ctx, opts, batch, states[lo:hi],
                             skiplengths, states_fresh=states_fresh,
                             lo=lo, hi=hi)
            for lo, hi in spans]

    def finish_slice(i):
        # slice complete: export its state/actions NOW so this host work
        # fills the other half's device time instead of running serially
        # after the drain.  On the LAST (index, part) slots can no longer
        # be replaced, so the slice's surviving tracebacks materialize
        # here too.
        lo, hi = spans[i]
        drvs[i].finish(states[lo:hi], readstats)
        finished[i] = True
        if ctx.is_last_index and ctx.is_last_part:
            from ..util import timed
            from .run import materialize_cigars_for
            with timed("cigar_mat"):
                materialize_cigars_for(states[lo:hi], opts)

    def submit(pend, mem):
        # the waves of slices `mem` (one strand buffer) in one device
        # call: (handle, [(slice, n_jobs), ...]).  Coord offsets are
        # absolute into buffers shared by every slice of a strand (q_data
        # is f04/r04, refs_data the part concat), so grouping is a pure
        # concatenation of the small coord arrays.
        jbs = [pend.pop(i) for i in mem]
        if len(jbs) == 1:
            h = backend.batch_coords_submit(*jbs[0])
        else:
            cat = [np.concatenate([jb[c] for jb in jbs])
                   for c in (1, 2, 4, 5, 6)]
            h = backend.batch_coords_submit(
                jbs[0][0], cat[0], cat[1], jbs[0][3],
                cat[2], cat[3], cat[4])
        return h, [(i, len(jb[1])) for i, jb in zip(mem, jbs)]

    def by_buffer(pend):
        # pending waves grouped by their query buffer, i.e. by strand
        by_q: dict = {}
        for i in sorted(pend):
            by_q.setdefault(id(pend[i][0]), []).append(i)
        return by_q.values()

    def post(h, mem):
        # fetch one submit's results and scatter them back to the
        # slices' drivers by per-slice job counts
        res = backend.batch_coords_fetch(h)
        o = 0
        for i, ni in mem:
            drvs[i].post(tuple(a[o:o + ni] for a in res))
            o += ni

    def pump(ids):
        # one pump of each slice of `ids`, all at once on the pool; a
        # slice whose pump finds no more work exports at once, in slice
        # order, on this thread
        pend = {}
        for i, jb in zip(ids, NativePartDriver.pump_many(
                [drvs[i] for i in ids])):
            if jb is None:
                finish_slice(i)
            else:
                pend[i] = jb
        return [submit(pend, mem) for mem in by_buffer(pend)]

    try:
        flight = [w for w in (pump(list(range(h, k, 2)))
                              for h in range(min(2, k))) if w]
        while flight:
            waves = flight.pop(0)
            for h, mem in waves:
                post(h, mem)
            waves = pump(sorted(i for _, mem in waves for i, _ in mem))
            if waves:
                flight.append(waves)
        for i, ((lo, hi), drv) in enumerate(zip(spans, drvs)):
            if not finished[i]:
                drv.finish(states[lo:hi], readstats)
    finally:
        for drv in drvs:
            drv.close()


def align_part(
    reads: List[ReadSeq],
    states: List[ReadState],
    part: IndexPart,
    ctx: PartContext,
    opts: Opts,
    skiplengths: Sequence[int],
    backend,
    readstats: Readstats,
    use_native: bool = True,
    batch: Optional["ReadBatch"] = None,
    states_fresh: bool = False,
) -> None:
    """Process one index part for a batch of reads: both strands
    (align2, processor.cpp:128-147)."""
    if batch is None:
        from .read import ReadBatch
        batch = ReadBatch(reads)

    single = opts.is_forward ^ opts.is_reverse
    num_strands = 1 if single else 2

    native_ok = use_native and hasattr(backend, "batch_coords")
    if native_ok:
        from .. import native
        native_ok = native.have_native()
    if native_ok and ctx.ref_seqs:
        # the native engine packs (seq,pos,win) into 64-bit keys with
        # 24-bit positions; gigantic single references fall back to the
        # python path
        native_ok = int(np.diff(ctx.ref_seqs.off).max()) < (1 << 24)

    # fully-native part driver: the whole pass/strand loop runs in C++
    # (native/driver.cpp); python only pumps device SW waves.  The
    # device-probe configuration keeps the python traverse (its prober
    # is a device function: ops/seed_search.py).
    if (native_ok and ctx.ref_seqs and batch.n
            and not getattr(opts, "device_probe", False)
            and 8 <= getattr(part, "seed_win_len", 18) <= 26):
        from .part_driver import NativePartDriver
        from ..util import timed
        overlap = (batch.n >= OVERLAP_MIN_READS
                   and hasattr(backend, "batch_coords_submit"))
        with timed("part_driver"):
            if overlap:
                _run_part_overlapped(part, ctx, opts, batch, states,
                                     skiplengths, backend, readstats,
                                     states_fresh)
            else:
                drv = NativePartDriver(part, ctx, opts, batch, states,
                                       skiplengths,
                                       states_fresh=states_fresh)
                try:
                    drv.run(backend, states, readstats)
                finally:
                    drv.close()
        return

    searcher = _make_searcher(part, opts, getattr(backend, "device", None))
    for count in range(num_strands):
        forward = not ((single and opts.is_reverse) or count == 1)
        is_last = single or count == 1
        long_enough = batch.lens >= ctx.lnwin
        ordinals = [i for i in range(batch.n)
                    if not states[i].is_done and long_enough[i]]
        if not ordinals:
            break
        engine = None
        if native_ok:
            from ..constants import scoring_matrix_5x5
            from .native_driver import NativeCandidateEngine
            mat = scoring_matrix_5x5(opts.match, opts.mismatch,
                                     opts.score_n)
            engine = NativeCandidateEngine(ctx, opts, reads, forward, mat,
                                           batch=batch)
        try:
            traverse_strand(reads, states, ordinals, forward, searcher,
                            ctx, opts, skiplengths, backend, readstats,
                            is_last, native_engine=engine, batch=batch)
        finally:
            if engine is not None:
                engine.finalize_stats(readstats)
                engine.close()


def load_part_refs(fasta_path: str, first_seq: int, numseq_part: int,
                   start_byte: Optional[int] = None
                   ) -> Tuple[List[np.ndarray], List[str]]:
    """References::load equivalent: the part's sequences in the alignment
    encoding (NT_TABLE: ambiguous -> 4; references.cpp:60-160).

    With ``start_byte`` (Part.start_part from the index artifact) the
    file is seeked straight to the part like the reference does
    (references.cpp:60) instead of scanning records from the top."""
    seqs: List[np.ndarray] = []
    headers: List[str] = []
    if start_byte is not None:
        with open(fasta_path, "rt") as f:
            f.seek(start_byte)
            hdr = None
            chunks: List[str] = []

            def flush():
                raw = np.frombuffer(
                    "".join(chunks).replace(" ", "").encode("ascii"),
                    dtype=np.uint8)
                seqs.append(NT_TABLE[raw])
                headers.append(hdr)

            for line in f:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                if line[0] == ">":
                    if hdr is not None:
                        flush()
                        if len(seqs) == numseq_part:
                            return seqs, headers
                    hdr = line[1:]
                    chunks = []
                else:
                    chunks.append(line)
            if hdr is not None and len(seqs) < numseq_part:
                flush()
        return seqs, headers
    from ..io.fastx import iter_fastx
    for i, rec in enumerate(iter_fastx(fasta_path)):
        if i < first_seq:
            continue
        if i >= first_seq + numseq_part:
            break
        raw = np.frombuffer(rec.sequence.replace(" ", "").encode("ascii"),
                            dtype=np.uint8)
        seqs.append(NT_TABLE[raw])
        headers.append(rec.header)
    return seqs, headers
