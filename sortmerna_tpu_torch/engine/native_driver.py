"""Python driver for the native candidate engine (native/engine.cpp).

Replaces the per-read Python coroutines of candidates.py in the hot path:
the C++ side runs every read's compute_lis_alignment state machine and
emits SW job coordinate arrays; the device scores them in fixed-shape
batches; accepted alignments come back as action records (append /
replace-min) that are applied to the Python ReadState objects.
"""

from __future__ import annotations


from typing import List

import numpy as np

from .. import native
from .candidates import Opts, PartContext, Readstats
from .read import Alignment, ReadSeq, ReadState


class NativeCandidateEngine:
    def __init__(self, ctx: PartContext, opts: Opts,
                 reads: List[ReadSeq], forward: bool,
                 mat: np.ndarray, batch=None):
        self.lib = native.get_lib()
        assert self.lib is not None
        self.ctx = ctx
        self.opts = opts
        self.n_reads = len(reads)
        self._forward = forward

        # the part's flat 04 buffers (kept alive for the engine's lifetime)
        self.refs_data, self.refs_off = ctx.ref_seqs.data, ctx.ref_seqs.off

        if batch is None:
            from .read import ReadBatch
            batch = ReadBatch(reads)
        self.reads_off = batch.offs
        from ..util import timed as _t
        with _t("batch_enc04"):
            self.reads_data = np.ascontiguousarray(
                batch.concat04(forward))

        self.pos_offsets = np.ascontiguousarray(ctx.pos_offsets, np.int64)
        self.pos_seq = np.ascontiguousarray(ctx.pos_seq, np.uint32)
        self.pos_pos = np.ascontiguousarray(ctx.pos_pos, np.uint32)
        self.mat = np.ascontiguousarray(mat, np.int8)

        from ..util import timed as _t1
        with _t1("engine_init"):
          self.h = self.lib.cand_create(
              self.pos_offsets.ctypes.data, self.pos_seq.ctypes.data,
              self.pos_pos.ctypes.data,
              self.refs_data.ctypes.data, self.refs_off.ctypes.data,
              len(ctx.ref_seqs),
              self.reads_data.ctypes.data, self.reads_off.ctypes.data,
              len(reads),
              opts.num_alignments, int(opts.is_best), opts.num_seeds,
              opts.min_lis, opts.edges, int(opts.is_as_percent),
              opts.match,
              int(ctx.minimal_score), ctx.lnwin, opts.gap_open,
              opts.gap_ext,
              ctx.index_num, ctx.part_num, self.mat.ctypes.data)
        self.lib.cand_set_threads(self.h, getattr(opts, "threads", 1))
        # per-read import tracking: once a read's state has been sent to
        # the engine (which keeps its own copy authoritative for its
        # lifetime, FSM.managed), later passes skip the python-side
        # attribute walk; _st5 mirrors the last state seen per read so
        # _collect only writes back genuinely-changed rows.
        # INVARIANT: while this engine is open, the managed fields of
        # ReadState (best, max_sw_count, is_hit, min_index, max_index,
        # alignments) must not be mutated from Python between passes --
        # the engine's copy is authoritative and such mutations would be
        # silently overwritten at the next _collect.
        self._sent = np.zeros(self.n_reads, bool)
        self._st5 = np.zeros((self.n_reads, 5), np.int32)

    def close(self):
        if self.h:
            from ..util import timers_enabled
            if timers_enabled():
                native.tally_sw_counts(self.h)
            self.lib.cand_destroy(self.h)
            self.h = None

    def run_pass_packed(self, ords: np.ndarray, hit_off: np.ndarray,
                        kids_all: np.ndarray, wins_all: np.ndarray,
                        states: List[ReadState], sw_backend,
                        readstats: Readstats) -> np.ndarray:
        """Packed form: ords int32[n] ascending, hit_off int64[n+1],
        kids/wins int64 concatenated per-read hit lists.  Returns the
        per-item search flags as a bool array aligned with ``ords``."""
        lib = self.lib
        base_aligned = lib.cand_stat_num_aligned(self.h)

        from ..util import timed as _timed
        with _timed("fsm_start"):
            self._start_packed(ords, hit_off, kids_all, wins_all, states)

        # SW waves (main + speculative jobs ride together)
        from ..util import timed
        while True:
            if lib.cand_num_active(self.h) == 0:
                break
            n_jobs = lib.cand_num_jobs(self.h)
            job_read = np.zeros(n_jobs, np.int32)
            q_off = np.zeros(n_jobs, np.int64)
            q_len = np.zeros(n_jobs, np.int32)
            r_off = np.zeros(n_jobs, np.int64)
            r_len = np.zeros(n_jobs, np.int32)
            minimal = np.zeros(n_jobs, np.int64)
            with timed("fsm_jobs"):
                n = lib.cand_next_jobs(
                    self.h, job_read.ctypes.data, q_off.ctypes.data,
                    q_len.ctypes.data, r_off.ctypes.data, r_len.ctypes.data,
                    minimal.ctypes.data)
            assert n == n_jobs
            with timed("sw_wave"):
                res = sw_backend.batch_coords(
                    self.reads_data, q_off, q_len,
                    self.refs_data, r_off, r_len, minimal)
            scores, rb, re, qb, qe = res
            with timed("fsm_post"):
                lib.cand_post(self.h, n, scores.ctypes.data,
                              rb.ctypes.data, re.ctypes.data,
                              qb.ctypes.data, qe.ctypes.data)

        with _timed("fsm_apply"):
            return self._collect(ords, states, readstats, base_aligned)

    def _start_packed(self, ords, hit_off, kids_all, wins_all, states):
        lib = self.lib
        n = len(ords)
        if not n:
            return
        hit_off = np.ascontiguousarray(hit_off, np.int64)
        kids_all = np.ascontiguousarray(kids_all, np.int64)
        wins_all = np.ascontiguousarray(wins_all, np.int64)
        ords = np.ascontiguousarray(ords, np.int32)
        st_off = np.zeros(n + 1, np.int64)
        state5 = np.zeros((n, 5), np.int32)
        sc_list, ix_list = [], []
        new_rows = np.flatnonzero(~self._sent[ords])
        if len(new_rows):
            ords_l = ords.tolist()
            cnts = np.zeros(n, np.int64)
            for i in new_rows.tolist():
                st = states[ords_l[i]]
                cnts[i] = len(st.alignments)
                state5[i] = (st.best, st.max_sw_count, int(st.is_hit),
                             st.min_index, st.max_index)
                for a in st.alignments:
                    sc_list.append(a.score1)
                    ix_list.append(a.index_num)
            np.cumsum(cnts, out=st_off[1:])
            self._st5[ords[new_rows]] = state5[new_rows]
            self._sent[ords[new_rows]] = True
        scores = np.asarray(sc_list or [0], np.int32)
        idxn = np.asarray(ix_list or [0], np.int32)
        lib.cand_start_batch(
            self.h, n, ords.ctypes.data, hit_off.ctypes.data,
            kids_all.ctypes.data, wins_all.ctypes.data,
            st_off.ctypes.data, scores.ctypes.data, idxn.ctypes.data,
            state5.ctypes.data)

    def _collect(self, ords, states, readstats, base_aligned
                 ) -> np.ndarray:
        lib = self.lib
        # collect search flags + state updates (one batched export)
        n_items = len(ords)
        ords = np.ascontiguousarray(ords, np.int32)
        st6 = np.zeros((n_items, 6), np.int32)
        if n_items:
            lib.cand_read_states_batch(self.h, ords.ctypes.data, n_items,
                                       st6.ctypes.data)
        out = st6[:, 0].astype(bool)
        # push back only rows the engine actually changed vs the last
        # state seen per read (the common read has no state delta)
        dirty = np.flatnonzero(
            (st6[:, 1:] != self._st5[ords]).any(axis=1))
        self._st5[ords[dirty]] = st6[dirty, 1:]
        st6l = st6[dirty].tolist()
        ords_d = ords[dirty].tolist()
        for ord_, row in zip(ords_d, st6l):
            st = states[ord_]
            st.best = row[1]
            st.max_sw_count = row[2]
            st.is_hit = bool(row[3])
            st.min_index = row[4]
            st.max_index = row[5]

        # apply actions (CIGARs deferred: copy the traceback windows now,
        # materialize in one batched native call for survivors)
        n_act = lib.cand_num_actions(self.h)
        if n_act:
            fields = np.zeros((n_act, 14), np.int32)
            woffs = np.zeros((n_act, 2), np.int64)
            lib.cand_export_actions(self.h, fields.ctypes.data,
                                    woffs.ctypes.data)
            for i in range(n_act):
                f = fields[i]
                ord_ = int(f[0])
                st = states[ord_]
                rw0, qw0 = int(woffs[i, 0]), int(woffs[i, 1])
                aln = Alignment(
                    index_num=self.ctx.index_num,
                    part=self.ctx.part_num,
                    ref_num=int(f[4]),
                    read_begin1=int(f[8]),
                    read_end1=int(f[9]),
                    ref_begin1=int(f[6]),
                    ref_end1=int(f[7]),
                    readlen=int(self.reads_off[ord_ + 1]
                                - self.reads_off[ord_]),
                    score1=int(f[5]),
                    strand=self._forward,
                    cigar=None,
                    tb=(self.refs_data[rw0:rw0 + int(f[10])].copy(),
                        self.reads_data[qw0:qw0 + int(f[11])].copy(),
                        int(f[12])),
                )
                if f[1] == 0:
                    st.alignments.append(aln)
                else:
                    st.alignments[int(f[2])] = aln
                st.is_new_hit = True
            lib.cand_clear_actions(self.h)

        # stat deltas (drained incrementally)
        readstats.num_aligned += int(
            lib.cand_stat_num_aligned(self.h) - base_aligned)
        return out

    def finalize_stats(self, readstats: Readstats):
        lib = self.lib
        n = lib.cand_stat_num_dbs(self.h)
        if n:
            dbs = np.zeros(n, np.int32)
            deltas = np.zeros(n, np.int64)
            lib.cand_stat_dbs(self.h, dbs.ctypes.data, deltas.ctypes.data)
            for d, v in zip(dbs, deltas):
                readstats.reads_matched_per_db[int(d)] += int(v)
