"""The control and the planted faults of the comparison.  Each is a
context manager that patches the port while it is open.

The SW ones wrap the port's SW launch (``sw_torch.sw_fused``), whose
int32 [5, B] result is (score, beg_ref, end_ref, beg_read, end_read):

- ``saturate8``: the control.  Scores saturate at 255, as in an 8-bit
  DP (SSW's byte pass without its 16-bit fall-back): the narrower
  arithmetic a faster kernel would be tempted to take, breaking the
  configuration's guarantee of exact int32 scores.
- ``unchanged``: the step returns its state unchanged: no score, no
  coordinates.
- ``half_batch``: the second half of every block is left out.
- ``altered``: the best pair's score in each block is one lower.
- ``clip_end``: the kernel stops an eighth of each read's rows early,
  as a route that drops a tile's last stripe would: score, ends and
  CIGAR agree with one another, and the alignment misses its tail.

And one in the statistics:

- ``gumbel_off``: the Gumbel lambda the program works with is 3% high
  and its K 30% high, and everything it derives from them follows.

``PAIRED_FAULTS`` are those of a cell with pairs and several databases
(each is a no-op on one database of single-end reads):

- ``mate_apart``: under ``-paired_in``, mate 2 of every fifth pair that
  aligned goes to other, and mate 1 alone to aligned.
- ``first_gumbel``: ``aligned.log`` states the first database's lambda
  and K in every database's block; the program works with its own.
- ``coverage_swapped``: the log's coverage lines of the first two
  databases are each other's.
- ``mate2_dropped``: mate 2 of every pair is left out of the search
  (marked done before each part, so it seeds nothing): half of the
  batch left out, with the pairs still filed by mate 1's alignments.
"""

from __future__ import annotations

import contextlib
import copy

NONE = (0, -1, -1, -1, -1)      # a pair that aligned nowhere


def _sw(before=None, after=None):
    @contextlib.contextmanager
    def fault():
        from sortmerna_tpu_torch.ops import sw_torch
        launch = sw_torch.sw_fused

        def inner(buf, mat, B, lq, lr, go, ge):
            if before is not None:
                before(buf)
            out = launch(buf, mat, B, lq, lr, go, ge)
            if after is not None:
                after(out, B)
            return out
        sw_torch.sw_fused = inner
        try:
            yield
        finally:
            sw_torch.sw_fused = launch
    return fault


def _saturate(out, B):
    out[0].clamp_(max=255)


def _unchanged(out, B):
    for k, v in enumerate(NONE):
        out[k].fill_(v)


def _half(out, B):
    for k, v in enumerate(NONE):
        out[k, B // 2:] = v


def _altered(out, B):
    out[0, out[0].argmax()] -= 1


def _clip(buf):
    import torch
    # each row's last 12 bytes: int32 read length, reference length,
    # minimal score
    ints = buf[:, -12:].clone().view(torch.int32)
    ints[:, 0] -= ints[:, 0] // 8
    buf[:, -12:] = ints.view(torch.uint8)


def gumbel_off(lam_scale: float, K_scale: float):
    @contextlib.contextmanager
    def fault():
        from sortmerna_tpu_torch.stats import refstats
        got = refstats._cached_gumbel

        def inner(*a, **kw):
            lam, K = got(*a, **kw)
            return lam * lam_scale, K * K_scale
        refstats._cached_gumbel = inner
        try:
            yield
        finally:
            refstats._cached_gumbel = got
    return fault


CONTROL = "saturate8"
FAULTS = {"saturate8": _sw(after=_saturate),
          "unchanged": _sw(after=_unchanged),
          "half_batch": _sw(after=_half),
          "altered": _sw(after=_altered),
          "clip_end": _sw(before=_clip),
          "gumbel_off": gumbel_off(1.03, 1.3)}


def _mate_apart():
    @contextlib.contextmanager
    def fault():
        from sortmerna_tpu_torch.reports.fastx import FastxReport
        append = FastxReport.append

        def inner(self, reads, states):
            if len(reads) == 2 and reads[0].read_num % 5 == 0 and \
                    (states[0].is_hit or states[1].is_hit):
                if self.other:
                    self.files[-1].write(self._record(reads[1]))
                else:
                    self.files[0].write(self._record(reads[0]))
                return
            append(self, reads, states)
        FastxReport.append = inner
        try:
            yield
        finally:
            FastxReport.append = append
    return fault


def _log(edit):
    """Patches what ``aligned.log`` states, through copies of the
    statistics handed to its writer."""
    @contextlib.contextmanager
    def fault():
        from sortmerna_tpu_torch.reports import summary
        text = summary.summary_text

        def inner(opts, refstats, readstats, *a, **kw):
            refstats, readstats = copy.copy(refstats), copy.copy(readstats)
            edit(refstats, readstats)
            return text(opts, refstats, readstats, *a, **kw)
        summary.summary_text = inner
        try:
            yield
        finally:
            summary.summary_text = text
    return fault


def _first_gumbel(refstats, readstats):
    refstats.gumbel = [refstats.gumbel[0]] * len(refstats.gumbel)


def _coverage_swapped(refstats, readstats):
    per = list(readstats.reads_matched_per_db)
    per[0], per[1] = per[1], per[0]
    readstats.reads_matched_per_db = per


def _mate2_dropped():
    @contextlib.contextmanager
    def fault():
        from sortmerna_tpu_torch.engine import run as run_mod
        align_part = run_mod.align_part

        def inner(reads, bstates, *a, states_fresh=False, **kw):
            # reads come in pairs, mate 2 at odd places of every batch;
            # the states are read from the objects, not made fresh
            for st in bstates[1::2]:
                st.is_done = True
            return align_part(reads, bstates, *a, states_fresh=False, **kw)
        run_mod.align_part = inner
        try:
            yield
        finally:
            run_mod.align_part = align_part
    return fault


PAIRED_FAULTS = {"mate_apart": _mate_apart(),
                 "first_gumbel": _log(_first_gumbel),
                 "coverage_swapped": _log(_coverage_swapped),
                 "mate2_dropped": _mate2_dropped()}
