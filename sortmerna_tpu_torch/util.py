"""Structured logging + stage spans (the reference's observability layer:
INFO/WARN/ERR macros with [function:line] stamps and chrono phase timers,
common.hpp:123-218, trace documented in README.md:154-161)."""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import sys
import threading
import time


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


# ---------------------------------------------------------------------------
# stage spans (on with SMR_TIMERS=1; read by the benchmark's --trace 1 runs)
#
# ``timed(name)`` adds the span's seconds and one to ``TIMERS[name]`` and,
# while a ``torch.profiler`` is running, lays the span on the trace as
# ``smr.<name>``, on the clock of the device's kernels and copies.  Off, it
# is one flag check that returns a shared no-op context: no clock read and
# no ``record_function``, which costs a call even with no profiler running.

TIMERS: dict = {}                 # name -> [seconds, count]
_TIMERS_ON = os.environ.get("SMR_TIMERS", "") not in ("", "0")
_LOCK = threading.Lock()          # spans close on pump and worker threads
_OFF = contextlib.nullcontext()


def timers_enabled() -> bool:
    return _TIMERS_ON


def tally(name: str, seconds: float = 0.0, count: int = 1) -> None:
    """Add to ``TIMERS[name]``: what a span does on exit, and how the
    native engine's counters are harvested (a count, no seconds)."""
    with _LOCK:
        e = TIMERS.setdefault(name, [0.0, 0])
        e[0] += seconds
        e[1] += count


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function
        self.rf = record_function("smr." + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        tally(self.name, dt)
        return False


def timed(name: str, *args):
    """A span named ``name``, or ``name % args`` (formatted only when
    spans are on)."""
    if not _TIMERS_ON:
        return _OFF
    return _Span(name % args if args else name)


def spanned(name: str):
    """Decorate a function with a ``timed(name)`` span around each call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with timed(name):
                return fn(*a, **kw)
        return inner
    return wrap
