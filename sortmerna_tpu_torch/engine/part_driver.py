"""Python pump for the native traverse driver (native/driver.cpp).

One NativePartDriver covers one (index-part, read-batch): the C++ side
owns the full multi-pass / both-strand traverse loop (window search,
probing, hit bookkeeping, candidate FSMs -- paralleltraversal.cpp:81-297
+ alignment.cpp:100-509 semantics), and Python's only per-wave job is
running the batched Smith-Waterman on the device:

    while n := trav_pump():            # C++ advances to next device work
        jobs -> sw_backend.batch_coords -> results back via cand_post

Read state imports/exports happen ONCE per part (not per pass); accepted
alignments export as action records applied to the ReadState objects at
part end.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from .candidates import Opts, PartContext, Readstats
from .read import Alignment, ReadState

class WinStore:
    """One part-export's traceback windows, held in place.

    ``Alignment.tb`` for engine-produced alignments is a
    ``(store, action_index)`` handle into these buffers -- no
    per-alignment window views are created at export and no bytes are
    copied to assemble the batched traceback (run.materialize_cigars
    computes pointer arrays into rbuf/qsrc vectorized)."""

    __slots__ = ("rbuf", "qsrc", "r_out", "q_out", "bands")

    def __init__(self, rbuf, qsrc, r_out, q_out, bands):
        self.rbuf = rbuf
        self.qsrc = qsrc
        self.r_out = r_out
        self.q_out = q_out
        self.bands = bands

    def window(self, i: int):
        """(ref_window, query_window, band) views for one action --
        the numpy fallback path of materialize_cigars."""
        return (self.rbuf[self.r_out[i]:self.r_out[i + 1]],
                self.qsrc[self.q_out[i]:self.q_out[i + 1]],
                int(self.bands[i]))


def _part_probe_bufs(part):
    """The 20 probe-table buffers in driver slot order (single source
    of truth: ops.seed_probe.probe_table_bufs, cached on the part)."""
    from ..ops.seed_probe import probe_table_bufs
    return probe_table_bufs(part)


class NativePartDriver:
    """One per (index-part, read-range).  ``lo``/``hi`` select a
    sub-range of the batch: the concat buffers are shared (offsets are
    absolute), so the overlap scheduler can run many slices of a batch
    against each other with zero copying."""

    def __init__(self, part, ctx: PartContext, opts: Opts,
                 batch, states: List[ReadState],
                 skiplengths, states_fresh: bool = False,
                 lo: int = 0, hi: int = None,
                 threads_override: int = None):
        self.lib = native.get_lib()
        assert self.lib is not None
        self.ctx = ctx
        self.opts = opts
        self.batch = batch
        hi = batch.n if hi is None else hi
        self.lo, self.hi = lo, hi
        n = hi - lo
        self.n = n
        assert len(states) == n

        pbufs = _part_probe_bufs(part)

        cached = getattr(ctx, "_refs_concat", None)
        if cached is None:
            refs_off = np.zeros(len(ctx.ref_seqs) + 1, dtype=np.int64)
            for i, s in enumerate(ctx.ref_seqs):
                refs_off[i + 1] = refs_off[i] + len(s)
            refs_data = (np.concatenate(
                [np.asarray(s, np.uint8) for s in ctx.ref_seqs])
                if ctx.ref_seqs else np.zeros(0, np.uint8))
            cached = (refs_data, refs_off)
            ctx._refs_concat = cached
        self.refs_data, self.refs_off = cached

        from ..util import timed
        with timed("batch_enc"):
            # encodings cache on the batch (one native pass); the offs
            # slice view keeps ABSOLUTE offsets so sub-range drivers
            # share the buffers
            self.reads_off = np.ascontiguousarray(
                batch.offs[lo:hi + 1], np.int64)
            batch.ensure_strands()
            self.f03 = np.ascontiguousarray(batch.concat03(True))
            self.r03 = np.ascontiguousarray(batch.concat03(False))
            self.f04 = np.ascontiguousarray(batch.concat04(True))
            self.r04 = np.ascontiguousarray(batch.concat04(False))

        pos_offsets = np.ascontiguousarray(ctx.pos_offsets, np.int64)
        pos_seq = np.ascontiguousarray(ctx.pos_seq, np.uint32)
        pos_pos = np.ascontiguousarray(ctx.pos_pos, np.uint32)
        from ..constants import scoring_matrix_5x5
        mat = np.ascontiguousarray(scoring_matrix_5x5(
            opts.match, opts.mismatch, opts.score_n), np.int8)
        skips = np.ascontiguousarray(
            np.asarray(list(skiplengths[:3]), np.int64))

        # per-read state import (once per part).  A fresh batch (first
        # part of a non-resumed run) synthesizes default state without
        # walking 100K+ python objects.
        with timed("state_import"):
            if states_fresh:
                state5 = np.zeros((n, 5), np.int32)
                if opts.min_lis > 0:
                    state5[:, 0] = opts.min_lis      # read.cpp:267
                hit_seeds = np.zeros(n, np.int32)
                is_done = np.zeros(n, np.uint8)
                st_off = np.zeros(n + 1, np.int64)
                scs = np.zeros(1, np.int32)
                ixs = np.zeros(1, np.int32)
            else:
                state5 = np.zeros((n, 5), np.int32)
                hit_seeds = np.zeros(n, np.int32)
                is_done = np.zeros(n, np.uint8)
                st_cnt = np.zeros(n, np.int64)
                sc_l: List[int] = []
                ix_l: List[int] = []
                for i, st in enumerate(states):
                    state5[i, 0] = st.best
                    state5[i, 1] = st.max_sw_count
                    state5[i, 2] = st.is_hit
                    state5[i, 3] = st.min_index
                    state5[i, 4] = st.max_index
                    hit_seeds[i] = st.hit_seeds
                    is_done[i] = st.is_done
                    if st.alignments:
                        st_cnt[i] = len(st.alignments)
                        for a in st.alignments:
                            sc_l.append(a.score1)
                            ix_l.append(a.index_num)
                st_off = np.zeros(n + 1, np.int64)
                np.cumsum(st_cnt, out=st_off[1:])
                scs = np.asarray(sc_l or [0], np.int32)
                ixs = np.asarray(ix_l or [0], np.int32)
        self._hit_seeds_in = hit_seeds
        self._is_done_in = is_done
        self._fresh = states_fresh

        single = opts.is_forward ^ opts.is_reverse
        num_strands = 1 if single else 2
        first_forward = 0 if (single and opts.is_reverse) else 1

        bufs_np = pbufs + [
            pos_offsets, pos_seq, pos_pos, self.refs_data, self.refs_off,
            self.reads_off, self.f03, self.r03, self.f04, self.r04,
            state5, hit_seeds, is_done, st_off, scs, ixs, mat, skips]
        self._keep = bufs_np            # lifetimes pinned to the driver
        ptrs = np.asarray([a.ctypes.data for a in bufs_np], np.uint64)
        ip = np.asarray([
            n, len(ctx.ref_seqs),
            len(pbufs[0]), len(pbufs[2]), len(pbufs[5]), len(pbufs[9]),
            len(pbufs[12]),
            opts.minoccur, int(opts.is_full_search),
            max(1, threads_override if threads_override is not None
                else getattr(opts, "threads", 1)),
            opts.num_alignments, int(opts.is_best), opts.num_seeds,
            opts.min_lis, opts.edges, int(opts.is_as_percent),
            opts.match, int(ctx.minimal_score), ctx.lnwin,
            opts.gap_open, opts.gap_ext, ctx.index_num, ctx.part_num,
            num_strands, first_forward,
            int(ctx.is_last_index), int(ctx.is_last_part)], np.int64)
        from ..util import timed as _t
        with _t("engine_init"):
            self.h = self.lib.trav_create(ptrs.ctypes.data, ip.ctypes.data)
        self.heng = self.lib.trav_engine(self.h)

    # ------------------------------------------------------------------
    def pump_jobs(self):
        """Advance the native driver to the next device wave.  Returns
        the batch_coords argument tuple, or None once the part is
        complete (results must then be collected with finish())."""
        lib = self.lib
        from ..util import timed
        with timed("trav_pump"):
            n = lib.trav_pump(self.h)
        if n < 0:
            raise ValueError(
                "native driver: probe_windows reported an unsupported "
                "seed half-width (stale .so? pw is validated to 4..13 "
                "upstream)")
        if n == 0:
            return None
        self._wave_n = n
        fwd = lib.trav_strand(self.h)
        job_read = np.zeros(n, np.int32)
        q_off = np.zeros(n, np.int64)
        q_len = np.zeros(n, np.int32)
        r_off = np.zeros(n, np.int64)
        r_len = np.zeros(n, np.int32)
        minimal = np.zeros(n, np.int64)
        with timed("fsm_jobs"):
            m = lib.cand_next_jobs(
                self.heng, job_read.ctypes.data, q_off.ctypes.data,
                q_len.ctypes.data, r_off.ctypes.data,
                r_len.ctypes.data, minimal.ctypes.data)
        assert m == n
        # jobs address the SHARED two-strand buffer (reverse jobs shift
        # by the forward length), so the overlap scheduler can
        # concatenate waves across strands into one device call
        fr = self.batch.fr04
        if not fwd:
            q_off += len(fr) // 2
        return (fr, q_off, q_len, self.refs_data, r_off, r_len,
                minimal)

    def post(self, res) -> None:
        """Feed one wave's SW results back into the native FSMs."""
        scores, rb, re, qb, qe = res
        from ..util import timed
        with timed("fsm_post"):
            self.lib.cand_post(self.heng, self._wave_n,
                               scores.ctypes.data,
                               rb.ctypes.data, re.ctypes.data,
                               qb.ctypes.data, qe.ctypes.data)

    def finish(self, states: List[ReadState],
               readstats: Readstats) -> None:
        from ..util import timed
        with timed("fsm_apply"):
            self._export(states, readstats)

    def run(self, sw_backend, states: List[ReadState],
            readstats: Readstats) -> None:
        from ..util import timed
        while True:
            jb = self.pump_jobs()
            if jb is None:
                break
            with timed("sw_wave"):
                res = sw_backend.batch_coords(*jb)
            self.post(res)
        self.finish(states, readstats)

    # ------------------------------------------------------------------
    def _export(self, states: List[ReadState],
                readstats: Readstats) -> None:
        from ..util import timed
        lib = self.lib
        n = self.n
        out = np.zeros((n, 8), np.int32)
        lib.trav_export(self.h, out.ctypes.data)
        flags = out[:, 7]
        managed = (flags & 1).astype(bool)
        dirty = np.flatnonzero(
            managed
            | (out[:, 5] != self._hit_seeds_in)
            | (out[:, 6] != self._is_done_in.astype(np.int32)))
        with timed("exp_state"):
            rows = out[dirty].tolist()
            for i, row in zip(dirty.tolist(), rows):
                st = states[i]
                st.best = row[0]
                st.max_sw_count = row[1]
                st.is_hit = bool(row[2])
                st.min_index = row[3]
                st.max_index = row[4]
                st.hit_seeds = row[5]
                st.is_done = bool(row[6])
        idx_num, part_num = self.ctx.index_num, self.ctx.part_num
        # last_index/last_part mirror the reference's KVDB blob
        # bookkeeping (read.cpp:429-462); nothing reads them back in
        # this engine, so writing the default (0,0) onto fresh states
        # is a no-op worth skipping -- the common single-part case
        if not (idx_num == 0 and part_num == 0 and self._fresh):
            touched = np.flatnonzero(flags & 2)
            for i in touched.tolist():
                st = states[i]
                st.last_index = idx_num
                st.last_part = part_num

        # actions -> Alignment records (CIGARs deferred; the traceback
        # windows copy out now, materialized for survivors in one
        # batched call, run.materialize_cigars).  Window bytes gather
        # into two per-part buffers with vectorized indexing; each
        # action's tb holds cheap views into them.
        n_act = lib.cand_num_actions(self.heng)
        if n_act:
            fields = np.zeros((n_act, 14), np.int32)
            woffs = np.zeros((n_act, 2), np.int64)
            lib.cand_export_actions(self.heng, fields.ctypes.data,
                                    woffs.ctypes.data)
            reads_off = self.reads_off
            with timed("exp_gather"):
                rl = fields[:, 10].astype(np.int64)
                ql = fields[:, 11].astype(np.int64)
                r_out = np.zeros(n_act + 1, np.int64)
                q_out = np.zeros(n_act + 1, np.int64)
                np.cumsum(rl, out=r_out[1:])
                np.cumsum(ql, out=q_out[1:])
                # one C++ pass (memcpy per span) instead of two
                # full-buffer numpy fancy-gathers + a strand select
                rbuf = np.empty(int(r_out[-1]), np.uint8)
                qsrc = np.empty(int(q_out[-1]), np.uint8)
                rlen32 = np.ascontiguousarray(fields[:, 10], np.int32)
                qlen32 = np.ascontiguousarray(fields[:, 11], np.int32)
                roff = np.ascontiguousarray(woffs[:, 0], np.int64)
                qoff = np.ascontiguousarray(woffs[:, 1], np.int64)
                fwd8 = np.ascontiguousarray(fields[:, 13], np.uint8)
                lib.gather_action_windows(
                    self.refs_data.ctypes.data, roff.ctypes.data,
                    rlen32.ctypes.data,
                    self.f04.ctypes.data, self.r04.ctypes.data,
                    qoff.ctypes.data, qlen32.ctypes.data,
                    fwd8.ctypes.data, n_act,
                    r_out.ctypes.data, q_out.ctypes.data,
                    rbuf.ctypes.data, qsrc.ctypes.data)
                del roff, qoff, rlen32, qlen32, fwd8
            with timed("exp_actions"):
                # positional slots construction over pre-extracted
                # columns: ~2x over a kwargs dataclass call per action.
                # tb is a (store, i) handle -- no window views here.
                store = WinStore(rbuf, qsrc, r_out, q_out,
                                 np.ascontiguousarray(fields[:, 12],
                                                      np.int32))
                readlens = (np.diff(reads_off)[fields[:, 0]]
                            .astype(np.int32).tolist())
                ords = fields[:, 0].tolist()
                kinds = fields[:, 1].tolist()
                slots_ = fields[:, 2].tolist()
                refn = fields[:, 4].tolist()
                sc = fields[:, 5].tolist()
                rb1 = fields[:, 6].tolist()
                re1 = fields[:, 7].tolist()
                qb1 = fields[:, 8].tolist()
                qe1 = fields[:, 9].tolist()
                fwds = fields[:, 13].astype(bool).tolist()
                A = Alignment
                for i in range(n_act):
                    ord_ = ords[i]
                    st = states[ord_]
                    aln = A(idx_num, part_num, refn[i], qb1[i], qe1[i],
                            rb1[i], re1[i], readlens[i], sc[i], fwds[i],
                            None, (store, i))
                    if kinds[i] == 0:
                        st.alignments.append(aln)
                    else:
                        st.alignments[slots_[i]] = aln
                    st.is_new_hit = True
            lib.cand_clear_actions(self.heng)

        readstats.num_aligned += int(lib.cand_stat_num_aligned(self.heng))
        n_dbs = lib.cand_stat_num_dbs(self.heng)
        if n_dbs:
            dbs = np.zeros(n_dbs, np.int32)
            deltas = np.zeros(n_dbs, np.int64)
            lib.cand_stat_dbs(self.heng, dbs.ctypes.data,
                              deltas.ctypes.data)
            for d, v in zip(dbs, deltas):
                readstats.reads_matched_per_db[int(d)] += int(v)

    # ------------------------------------------------------------------
    def close(self):
        if self.h:
            from ..util import TIMERS, timers_enabled
            if timers_enabled():
                t9 = np.zeros(9, np.float64)
                self.lib.cand_timers(self.heng, t9.ctypes.data)
                d9 = np.zeros(9, np.float64)
                self.lib.trav_timers(self.h, d9.ctypes.data)
                for k, v, c in (("cpp_build", t9[0], 1),
                                ("cpp_advance", t9[1], 1),
                                ("cpp_lis", t9[2], int(t9[4])),
                                ("cpp_traceback", t9[3], int(t9[5])),
                                ("cpp_triples", t9[6] / 1e9, int(t9[6])),
                                ("sw_jobs_scored", 0.0, int(t9[7])),
                                ("sw_jobs_consumed", 0.0, int(t9[8])),
                                ("drv_pack", d9[0], 1),
                                ("drv_enum", d9[1], int(d9[6])),
                                ("drv_probe", d9[2], int(d9[7])),
                                ("drv_attr", d9[3], 1),
                                ("drv_start", d9[4], 1),
                                ("drv_adv", d9[5], int(d9[8]))):
                    e = TIMERS.setdefault(k, [0.0, 0])
                    e[0] += float(v)
                    e[1] += c
            self.lib.trav_destroy(self.h)
            self.h = None
