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
"""

from __future__ import annotations

import contextlib

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
