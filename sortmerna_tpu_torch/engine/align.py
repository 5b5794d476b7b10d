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

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import NT_TABLE, PARTIAL_WIN, SEED_WIN_LEN, scoring_matrix_5x5
from ..index.builder import BuiltIndex, IndexPart
from ..ops.seed_probe import SeedSearcher
from ..ops import sw_ref
from .candidates import (Opts, PartContext, Readstats, SwJob,
                         compute_lis_alignment)
from .read import ReadSeq, ReadState


# ---------------------------------------------------------------------------
# SW backends


class NumpySwBackend:
    """Host fallback backend: per-job align_full (ops/sw_ref.py)."""

    def __init__(self, mat: np.ndarray, gap_open: int, gap_ext: int):
        self.mat = mat.astype(np.int64)
        self.gap_open = gap_open
        self.gap_ext = gap_ext

    def batch(self, jobs: Sequence[SwJob]) -> List[dict]:
        out = []
        for j in jobs:
            out.append(sw_ref.align_full(
                np.asarray(j.query, dtype=np.int64),
                np.asarray(j.ref, dtype=np.int64),
                self.mat, self.gap_open, self.gap_ext, j.minimal_score))
        return out


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


def _make_searcher(part, opts: Opts):
    """SeedSearcher for this part.  The device prober (--device_probe /
    SMR_DEVICE_PROBE) is not ported yet and raises."""
    if getattr(opts, "device_probe", False):
        raise NotImplementedError(
            "--device_probe (the device d<=1 seed probe, "
            "ops/seed_search.py) is not ported to sortmerna_tpu_torch yet")
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


def _overlap_enabled() -> bool:
    """Half-batch pipelining: one half's device waves hide behind the
    other half's host stages.  Default ON for any host with >=2 cores;
    SMR_OVERLAP=1/0 overrides."""
    v = os.environ.get("SMR_OVERLAP")
    if v is not None:
        return v not in ("0", "", "false")
    return (os.cpu_count() or 1) >= 2


def _run_part_overlapped(part, ctx, opts, batch, states, skiplengths,
                         backend, readstats, states_fresh) -> None:
    """Pipelined part sweep: the batch splits into read-range slices
    (independent reads, shared concat buffers); while some slices' SW
    waves compute on the device, the others run their host stages
    (probe, FSM start, result application), and the grouped scheduler
    concatenates several slices' waves -- across both strands -- into
    each device call.  Results are byte-identical to the single-driver
    sweep: reads never interact within a part.
    """
    from .part_driver import NativePartDriver

    # Split count trades finer host/device interleave (each sub-range's
    # FIRST wave is the big one; smaller slices expose less device wait
    # behind too little host work) against per-driver overhead.  Device
    # dispatches do not scale with the split -- the grouped interleave
    # below concatenates SMR_WAVE_GROUP slices' waves into one submit.
    k_env = os.environ.get("SMR_OVERLAP_SPLIT")
    if k_env is not None:
        k = int(k_env)
    else:
        # a GPU backend benefits from fine slicing (device time to hide
        # behind host stages); on the CPU extra waves are pure overhead
        dev = getattr(backend, "device", None)
        k = 24 if getattr(dev, "type", "cpu") == "cuda" else 2
    k = max(2, min(k, 32))
    cuts = [batch.n * i // k for i in range(k + 1)]
    spans = [(cuts[i], cuts[i + 1]) for i in range(k)
             if cuts[i] < cuts[i + 1]]
    k = len(spans)
    nworkers = int(os.environ.get("SMR_OVERLAP_THREADS", "1"))
    # Thread-parallel schedulers (SMR_OVERLAP_THREADS, SMR_PUMP_WORKERS)
    # stay for experiments; the default is the single-thread interleave.
    n_pump = int(os.environ.get("SMR_PUMP_WORKERS", "0")) \
        if nworkers <= 1 else 0
    # with concurrent pump workers each pump runs single-threaded
    # internally (worker-level parallelism replaces stage-level)
    tov = 1 if n_pump > 1 else None
    finished = [False] * k      # slices exported early by the grouped
                                # interleave (skipped in the final sweep)
    drvs = [NativePartDriver(part, ctx, opts, batch, states[lo:hi],
                             skiplengths, states_fresh=states_fresh,
                             lo=lo, hi=hi, threads_override=tov)
            for lo, hi in spans]
    # The explicit submit/fetch split keeps several slices' waves in
    # flight, where a thread blocking on each batch_coords would
    # serialize on every fetch.
    try:
        if nworkers > 1:
            # Worker-pool scheduler: each worker drives whole slices
            # (pump -> submit -> blocking fetch -> post); a blocking
            # fetch releases the GIL (C transfer wait), so the other
            # worker's host stages run on the second core.  The round-4
            # thread-per-half failure mode (two blocking fetches
            # starving submission) is diluted by k slices per worker.
            import queue as _queue
            import threading as _threading
            work: "_queue.SimpleQueue[int]" = _queue.SimpleQueue()
            for i in range(k):
                work.put(i)
            errs: list = []

            def drive():
                while True:
                    try:
                        i = work.get_nowait()
                    except _queue.Empty:
                        return
                    try:
                        while True:
                            jb = drvs[i].pump_jobs()
                            if jb is None:
                                break
                            h = backend.batch_coords_submit(*jb)
                            drvs[i].post(backend.batch_coords_fetch(h))
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)
                        return

            ths = [_threading.Thread(target=drive)
                   for _ in range(min(nworkers, k))]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            if errs:
                raise errs[0]
        elif n_pump > 0:
            # Pipelined scheduler: n_pump helper threads run the native
            # pumps CONCURRENTLY (trav_pump releases the GIL; with >1
            # workers each pump is internally single-threaded, so
            # worker-level parallelism covers the pump's serial stages
            # too), while the main thread does the GIL-bound stages
            # (submit fill, device fetch, post).  Slices cycle
            # pump -> submit -> fetch -> post independently, so pumps
            # overlap other slices' device/GIL stages.  Results are
            # byte-identical: slices never interact and each slice's
            # stage order is preserved.
            from concurrent.futures import ThreadPoolExecutor
            hands = [None] * k
            futs = [None] * k
            live = k
            with ThreadPoolExecutor(n_pump) as ex:
                for i in range(k):
                    futs[i] = ex.submit(drvs[i].pump_jobs)
                while live:
                    progressed = False
                    for i in range(k):
                        if futs[i] is not None and futs[i].done():
                            jb = futs[i].result()
                            futs[i] = None
                            if jb is None:
                                live -= 1
                            else:
                                hands[i] = \
                                    backend.batch_coords_submit(*jb)
                            progressed = True
                        elif hands[i] is not None:
                            res = backend.batch_coords_fetch(hands[i])
                            hands[i] = None
                            drvs[i].post(res)
                            futs[i] = ex.submit(drvs[i].pump_jobs)
                            progressed = True
                    if not progressed:
                        # every slice is pump-pending; wait for the
                        # FIRST pump to finish (not an arbitrary one --
                        # blocking on a queued-last future serializes
                        # the whole pipeline behind it)
                        from concurrent.futures import (FIRST_COMPLETED,
                                                        wait as _wait)
                        pending = [f for f in futs if f is not None]
                        if pending:
                            _wait(pending, return_when=FIRST_COMPLETED)
        else:
            # Grouped interleave (default): same per-slice pump/post
            # order as a plain interleave, but up to SMR_WAVE_GROUP
            # slices' waves concatenate into ONE device submit, so the
            # dispatch count does not grow with the split.
            # Coord offsets are absolute into buffers shared by every
            # slice of a strand (q_data is f04/r04, refs_data is the
            # part concat), so grouping is a pure np.concatenate of the
            # small coord arrays; results scatter back by per-slice job
            # counts.  Byte-identical: slices never interact and each
            # slice's in-order pass sequence is preserved.
            import numpy as _np
            grp = max(1, int(os.environ.get("SMR_WAVE_GROUP", "4")))
            # force partial groups out whenever fewer than `depth`
            # waves are in flight, so the device is never idle waiting
            # on a full group to assemble (2 keeps the device fed
            # through part tails)
            depth = int(os.environ.get("SMR_FLUSH_DEPTH", "2"))

            def finish_slice(i, lock=None):
                # slice complete: export its state/actions NOW so this
                # host work fills other groups' device time instead of
                # running serially after the drain.  On the LAST
                # (index, part) slots can no longer be replaced, so the
                # slice's surviving tracebacks materialize here too
                # (outside the lock -- slices are disjoint; only the
                # shared readstats/finished updates need serializing).
                lo_, hi_ = spans[i]
                if lock is None:
                    drvs[i].finish(states[lo_:hi_], readstats)
                    finished[i] = True
                else:
                    with lock:
                        drvs[i].finish(states[lo_:hi_], readstats)
                        finished[i] = True
                if ctx.is_last_index and ctx.is_last_part:
                    from ..util import timed as _timed
                    from .run import materialize_cigars_for
                    with _timed("cigar_mat"):
                        materialize_cigars_for(states[lo_:hi_], opts)

            def pump_into(i, pend, lock=None):
                jb = drvs[i].pump_jobs()
                if jb is not None:
                    pend[i] = jb
                else:
                    finish_slice(i, lock)

            def flush_into(pend, flight, force):
                by_q: dict = {}
                for i in sorted(pend):
                    by_q.setdefault(id(pend[i][0]), []).append(i)
                for ids in by_q.values():
                    j0 = 0
                    while len(ids) - j0 >= grp or (force and j0 < len(ids)):
                        mem = ids[j0:j0 + grp]
                        j0 += len(mem)
                        jbs = [pend.pop(i) for i in mem]
                        if len(jbs) == 1:
                            h = backend.batch_coords_submit(*jbs[0])
                        else:
                            cat = [_np.concatenate([jb[c] for jb in jbs])
                                   for c in (1, 2, 4, 5, 6)]
                            h = backend.batch_coords_submit(
                                jbs[0][0], cat[0], cat[1], jbs[0][3],
                                cat[2], cat[3], cat[4])
                        flight.append(
                            (h, [(i, len(jb[1]))
                                 for i, jb in zip(mem, jbs)]))

            def run_slices(slice_ids, lock=None):
                # one grouped pump/submit/fetch/post loop over a set of
                # slices with its own queues (the whole batch for the
                # default single-thread interleave; a round-robin
                # partition per worker under SMR_GROUP_WORKERS)
                pend: dict = {}   # slice -> job tuple awaiting submit
                flight: list = []  # (handle, [(slice, n_jobs), ...])
                for i in slice_ids:
                    pump_into(i, pend, lock)
                    if len(pend) >= grp:
                        flush_into(pend, flight, False)
                flush_into(pend, flight, True)
                while flight or pend:
                    if not flight:
                        flush_into(pend, flight, True)
                        continue
                    h, mem = flight.pop(0)
                    res = backend.batch_coords_fetch(h)
                    o = 0
                    for i, ni in mem:
                        drvs[i].post(tuple(a[o:o + ni] for a in res))
                        o += ni
                        pump_into(i, pend, lock)
                    flush_into(pend, flight, depth > len(flight))

            if int(os.environ.get("SMR_PUMP_HELPER", "0")):
                # Async-pump variant: ONE helper thread runs the native
                # pumps (trav_pump is a ctypes call -- the GIL is
                # released for the whole C++ stage), so the pump keeps
                # running while the main thread submits and fetches.
                # Posts, submits, fetches and exports stay on the main
                # thread; each slice's post happens-before its next
                # pump, so per-slice order (and byte-identity) is
                # preserved.  Opt-in: the helper contends with the
                # pump's internal probe threads for cores.
                from concurrent.futures import (FIRST_COMPLETED,
                                                ThreadPoolExecutor,
                                                wait as _wait)
                pend: dict = {}
                flight: list = []
                with ThreadPoolExecutor(1) as ex:
                    futs = {i: ex.submit(drvs[i].pump_jobs)
                            for i in range(k)}
                    while futs or flight or pend:
                        moved = False
                        for i in [i for i, f in futs.items()
                                  if f.done()]:
                            jb = futs.pop(i).result()
                            moved = True
                            if jb is None:
                                finish_slice(i)
                            else:
                                pend[i] = jb
                        flush_into(pend, flight,
                                   not flight and not futs)
                        if flight:
                            h, mem = flight.pop(0)
                            res = backend.batch_coords_fetch(h)
                            o = 0
                            for i, ni in mem:
                                drvs[i].post(
                                    tuple(a[o:o + ni] for a in res))
                                o += ni
                                futs[i] = ex.submit(drvs[i].pump_jobs)
                        elif futs and not moved:
                            _wait(list(futs.values()),
                                  return_when=FIRST_COMPLETED)
            elif int(os.environ.get("SMR_GROUP_WORKERS", "1")) > 1:
                # Symmetric grouped workers: slices partition
                # round-robin across W threads, each running run_slices
                # over its own queues.  One worker's GIL-free C stages
                # (ctypes pump, fetch transfer waits) overlap the
                # others' GIL-bound glue; finish/readstats updates
                # serialize on a lock.  Byte-identity holds: slices
                # never interact and each slice's order is preserved
                # within its worker.  Opt-in.
                import threading as _threading
                nwork = int(os.environ.get("SMR_GROUP_WORKERS", "1"))
                fin_lock = _threading.Lock()
                errs: list = []

                def worker(slice_ids):
                    try:
                        run_slices(slice_ids, fin_lock)
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)

                ths = [_threading.Thread(
                    target=worker, args=(list(range(w, k, nwork)),))
                    for w in range(min(nwork, k))]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join()
                if errs:
                    raise errs[0]
            else:
                run_slices(range(k))
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
        native_ok = max(len(s) for s in ctx.ref_seqs) < (1 << 24)

    # fully-native part driver: the whole pass/strand loop runs in C++
    # (native/driver.cpp); python only pumps device SW waves.  The
    # device-probe configuration keeps the python traverse (its prober
    # is a device function, not ported yet).
    if (native_ok and ctx.ref_seqs and batch.n
            and not getattr(opts, "device_probe", False)
            and 8 <= getattr(part, "seed_win_len", 18) <= 26):
        from .part_driver import NativePartDriver
        from ..util import timed
        overlap = (batch.n >= OVERLAP_MIN_READS
                   and hasattr(backend, "batch_coords_submit")
                   and _overlap_enabled())
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

    searcher = _make_searcher(part, opts)
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
