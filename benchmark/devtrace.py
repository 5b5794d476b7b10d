"""Reduction of a ``torch.profiler`` trace to device busy time, idle
gaps by host phase, and kernel time by name.

The benchmark opens ``bench.*`` spans (``record_function``) around the
window, each job and each ``run_all`` phase; device operations are the
trace's kernels, copies and sets.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
PHASES = ("bench.prepare", "bench.run_align", "bench.run_postprocess",
          "bench.run_reports")


def load(path: str) -> Tuple[List[tuple], List[tuple]]:
    """(device ops, bench spans) as (name, start_us, end_us)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        row = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + e["dur"])
        if e.get("cat") in DEVICE_CATS:
            ops.append(row)
        elif row[0].startswith("bench."):
            spans.append(row)
    return ops, spans


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_phase(t: float, spans: List[tuple]) -> str:
    inner = [s for s in spans if s[1] <= t < s[2] and s[0] in PHASES]
    if inner:
        return inner[0][0][len("bench."):]
    if any(s[1] <= t < s[2] for s in spans if s[0] == "bench.job"):
        return "state_other"
    return "between_jobs"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template and
    argument lists: ``void (anonymous namespace)::k<8>(int*)`` -> ``k``."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[(<]", name, 1)[0].strip()[:120] or name[:120]


def reduce(ops: List[tuple], spans: List[tuple]) -> Dict:
    """Busy and window seconds, the kernels' time by name, and the ten
    longest idle gaps named by the host phase around them."""
    win = [s for s in spans if s[0] == "bench.window"]
    if not win or not ops:
        return {}
    w0, w1 = win[0][1], win[0][2]
    inside = [(max(a, w0), min(b, w1), n) for n, a, b in ops
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in inside])
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in inside:
        by_name[short_name(n)] += (b - a) / 1e6
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((a - t, (a + t) / 2))
        t = max(t, b)
    gaps.sort(reverse=True)
    return dict(
        busy_s=sum(b - a for a, b in busy) / 1e6,
        window_s=(w1 - w0) / 1e6,
        op_s=dict(by_name),
        device_ops=sorted(([k, v] for k, v in by_name.items()),
                          key=lambda r: -r[1])[:10],
        idle_gaps=[[_host_phase(mid, spans), g / 1e6]
                   for g, mid in gaps[:10]],
    )
