"""The SW wave kernel's share of its roofline, in %: the bound of every
``sw_fused`` launch in the window (counted at its fetch from its shapes
and results by ``reference/roofline.py``) over the device time of the
``sw_fused_kernel`` and ``sw_fused_long_kernel`` launches in the
profiler's trace."""

import re

KERNEL = re.compile(r"\bsw_fused(_long)?_kernel\b")


def read(obs):
    ops = obs["device"].get("op_s", {})
    t = sum(v for k, v in ops.items() if KERNEL.search(k))
    if t <= 0 or obs["sw_launches"] == 0:
        return None
    return 100.0 * obs["sw_bound_s"] / t
