"""Structured logging + phase timing (the reference's observability layer:
INFO/WARN/ERR macros with [function:line] stamps and chrono phase timers,
common.hpp:123-218, trace documented in README.md:154-161)."""

from __future__ import annotations

import contextlib
import inspect
import os
import sys
import time
from typing import Optional


def _stamp() -> str:
    fr = inspect.currentframe().f_back.f_back
    fn = fr.f_code.co_name
    return f"[{fn}:{fr.f_lineno}]"


_VERBOSE = os.environ.get("SMR_TPU_LOG", "1") != "0"


def INFO(*args) -> None:
    if _VERBOSE:
        print(f"[{time.strftime('%H:%M:%S')}] {_stamp()}",
              *args, file=sys.stderr, flush=True)


def WARN(*args) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] WARNING {_stamp()}",
          *args, file=sys.stderr, flush=True)


def ERR(*args) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] ERROR {_stamp()}",
          *args, file=sys.stderr, flush=True)


def get_memory_kb() -> int:
    """RSS probe (get_memory, common.hpp:135-146)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


class PhaseTimer:
    """Accumulates named phase durations; printable summary."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(f"  {k:30s} {v:8.2f}s  x{self.counts[k]}"
                         for k, v in rows)


TIMER = PhaseTimer()


# ---------------------------------------------------------------------------
# lightweight stage timers (enabled with SMR_TIMERS=1; printed by bench)

TIMERS: dict = {}
_TIMERS_ON = os.environ.get("SMR_TIMERS", "") not in ("", "0")


def timers_enabled() -> bool:
    return _TIMERS_ON


@contextlib.contextmanager
def timed(name: str):
    if not _TIMERS_ON:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        e = TIMERS.setdefault(name, [0.0, 0])
        e[0] += dt
        e[1] += 1


def timers_report() -> str:
    return " ".join(f"{k}={v[0]:.2f}s/{v[1]}"
                    for k, v in sorted(TIMERS.items()))
