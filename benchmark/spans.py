"""The port's own spans laid on the device trace: the card's idle time
charged to what the port was doing.

With ``SMR_TIMERS`` on, each ``util.timed`` span of the port is also a
``record_function`` named ``smr.<stage>``, so a profiled window holds
them on the clock of the kernels and copies.  ``reduce`` charges each
idle interval of the card inside ``bench.window`` to the innermost
``smr.*`` span covering it on the thread that opened the window (the
one that runs the CLI), or to ``outside`` where none covers it.
Spans on other threads (pump helpers, group workers) reach the stage
timers but not this charge.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>
                               --trace 1

runs ``run.py`` with the same arguments and result, and in a traced run
on the card adds one line to standard error: the idle seconds by span,
and the idle shares of the window inside and outside ``smr.run_align``.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import devtrace  # noqa: E402

PREFIX = "smr."
ALIGN = "run_align"


def load(path: str) -> Tuple[List[tuple], List[tuple], Optional[tuple]]:
    """(device ops as (name, start_us, end_us); the host's ``smr.*``
    spans as (name without the prefix, start_us, end_us, tid); the
    ``bench.window`` span as (start_us, end_us, tid), or None).  The
    ``gpu_user_annotation`` copies that the profiler lays on the device
    lanes are neither device work nor host spans."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in devtrace.DEVICE_CATS:
            ops.append((name, a, b))
        elif cat == "user_annotation":
            if name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], a, b, e.get("tid")))
            elif name == "bench.window":
                window = (a, b, e.get("tid"))
    return ops, spans, window


def _idle(ops: List[tuple], w0: float, w1: float) -> List[Tuple[float,
                                                                 float]]:
    busy = devtrace._union([(max(a, w0), min(b, w1)) for _, a, b in ops
                            if b > w0 and a < w1])
    out, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    return out


def reduce(ops: List[tuple], spans: List[tuple],
           window: Optional[tuple]) -> Dict:
    """The idle seconds of the window by innermost span (``idle_by_span``,
    ``outside`` where no span covers the card's idle time), and the idle
    shares of the window in % inside ``smr.run_align`` and outside it,
    which sum to the card's idle share."""
    if window is None or not ops:
        return {}
    w0, w1, tid = window
    idle = _idle(ops, w0, w1)
    own = sorted(((max(a, w0), min(b, w1), n) for n, a, b, t in spans
                  if t == tid and b > w0 and a < w1),
                 key=lambda s: (s[0], -s[1]))
    # a sweep over every boundary: between two of them the card is idle
    # or busy throughout, and the open spans do not change
    cuts = sorted({t for a, b in idle for t in (a, b)}
                  | {t for a, b, _ in own for t in (a, b)})
    by_span: Dict[str, float] = defaultdict(float)
    in_align = 0.0
    stack: List[tuple] = []
    i = j = 0
    for t, t1 in zip(cuts, cuts[1:]):
        while stack and stack[-1][1] <= t:
            stack.pop()
        while i < len(own) and own[i][0] <= t:
            if own[i][1] > t:
                stack.append(own[i])
            i += 1
        while j < len(idle) and idle[j][1] <= t:
            j += 1
        if j == len(idle) or idle[j][0] > t:
            continue                      # the card is busy here
        live = [s for s in stack if s[1] > t]
        by_span[live[-1][2] if live else "outside"] += (t1 - t) / 1e6
        if any(s[2] == ALIGN for s in live):
            in_align += (t1 - t) / 1e6
    window_s = (w1 - w0) / 1e6
    idle_s = sum(b - a for a, b in idle) / 1e6
    return dict(
        idle_by_span=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        idle_s=idle_s, window_s=window_s,
        idle_in_align=100.0 * in_align / window_s,
        idle_outside_align=100.0 * (idle_s - in_align) / window_s)


def line(d: Dict) -> str:
    return ("idle by span: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in d["idle_by_span"].items())
        + f"; idle in run_align {d['idle_in_align']:.3f}%, outside "
        f"{d['idle_outside_align']:.3f}% of the window")


def main(argv=None) -> int:
    """``run.main`` with each exported trace also charged here."""
    import run
    load_ops = devtrace.load

    def load_and_charge(path):
        d = reduce(*load(path))
        if d:
            run.log(line(d))
        return load_ops(path)

    devtrace.load = load_and_charge
    try:
        return run.main(argv)
    finally:
        devtrace.load = load_ops


if __name__ == "__main__":
    sys.exit(main())
