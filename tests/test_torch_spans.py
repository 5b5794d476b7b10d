"""The port's stage spans (``util.timed``) and what the benchmark reads
from them.

* Off (``SMR_TIMERS`` unset), a CLI job leaves ``TIMERS`` empty, enters
  no ``record_function`` and reads no clock in ``timed``.
* On, under a CPU ``torch.profiler``, the job's spans reach the trace as
  ``smr.<stage>``, nested as the program runs them, their ``TIMERS``
  totals agree with the trace, and the benchmark's readers of them give
  sane values.
* A span closed on many threads at once loses no update.
* ``benchmark/spans.py`` charges the card's idle time to the innermost
  span on the window's thread, and its two idle shares sum to the idle
  share that ``devtrace`` gives.
"""

import importlib.util
import json
import os
import sys
import threading
import time
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing, util               # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

import devtrace  # noqa: E402
import spans  # noqa: E402


def reader(metric):
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "spans_test_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW_METRICS = ("part_driver.host_s_per_mnt", "sw.wait_s_per_mnt",
               "sw.useful_share", "state_save.s_per_mnt",
               "sw.rounds_per_start")
HOST_STAGES = ("trav_pump", "fsm_jobs", "fsm_post", "fsm_apply",
               "batch_enc", "state_import", "engine_init")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A tiny CPU job's files and the CLI call that runs it into a
    fresh workdir; returns the job's read nucleotides in millions."""
    top = tmp_path_factory.mktemp("spans")
    db, reads, idx = str(top / "db.fa"), str(top / "r.fa"), top / "idx"
    seqs = testing.make_db(db, 40, n_families=5, len_range=(1300, 1500),
                           seed=5)
    testing.make_reads(reads, seqs, 400, seed=6)
    idx.mkdir()
    runs = []

    def run():
        wd = str(top / f"wd{len(runs)}")
        runs.append(wd)
        assert tcli.main(["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS
                         + ["-idx-dir", str(idx), "-workdir", wd]) == 0
        nt = sum(len(line.strip()) for line in open(reads)
                 if not line.startswith(">"))
        return nt / 1e6

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMR_TORCH_DEVICE", "cpu")
        mp.setenv("SMR_TPU_LOG", "0")
        yield run


@pytest.fixture(scope="module")
def traced(job, tmp_path_factory):
    """The job once with spans on, under a CPU profiler: (TIMERS, the
    trace's smr.* spans on the window's thread, the job's Mnt)."""
    P = torch.profiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(util, "_TIMERS_ON", True)
        mp.setattr(util, "TIMERS", {})
        with P.profile(activities=[P.ProfilerActivity.CPU]) as prof:
            with P.record_function("bench.window"):
                mnt = job()
        timers = {k: list(v) for k, v in util.TIMERS.items()}
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    prof.export_chrome_trace(path)
    _, got, window = spans.load(path)
    return timers, [s for s in got if s[3] == window[2]], mnt


def test_off_leaves_no_trace(job, monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        raise AssertionError("record_function entered with spans off")

    class NoClock:          # util's time module, without its clock
        strftime = staticmethod(time.strftime)

        @staticmethod
        def perf_counter():
            raise AssertionError("clock read with spans off")

    monkeypatch.setattr(util, "_TIMERS_ON", False)
    monkeypatch.setattr(util, "TIMERS", {})
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(util, "time", NoClock)
    # one shared no-op whatever the name: nothing is built per call
    assert util.timed("a") is util.timed("sw_submit[%dx%dx%d]", 1, 2, 3)
    job()
    assert util.TIMERS == {} and entered == []


def test_spans_nest_on_the_trace(traced):
    _, got, _ = traced
    first = {}
    for name, a, b, _ in got:
        first.setdefault(name, (a, b))

    def inside(inner, outer):
        return first[outer][0] <= first[inner][0] \
            and first[inner][1] <= first[outer][1]

    for inner, outer in (("prepare", "run_all"), ("feed", "prepare"),
                         ("index_load", "prepare"), ("refstats", "prepare"),
                         ("run_align", "run_all"),
                         ("part_driver", "run_align"),
                         ("trav_pump", "part_driver"),
                         ("state_save", "run_all"),
                         ("summary", "run_all"),
                         ("run_reports", "run_all"),
                         ("reports_fastx", "run_reports"),
                         ("reports_blast", "run_reports")):
        assert inside(inner, outer), (inner, outer)
    assert first["prepare"][1] <= first["run_align"][0]
    assert first["run_align"][1] <= first["state_save"][0]
    assert first["state_save"][1] <= first["run_reports"][0]
    assert first["reports_fastx"][1] <= first["reports_blast"][0]


def test_timers_agree_with_the_trace(traced):
    timers, got, _ = traced
    tot, cnt = defaultdict(float), defaultdict(int)
    for name, a, b, _ in got:
        tot[name] += (b - a) / 1e6
        cnt[name] += 1
    spans_s = {k: v for k, v in timers.items()       # counts, not spans
               if not k.startswith(("sw_jobs_", "sw_fsm_"))}
    for name, (s, n) in spans_s.items():
        assert cnt[name] == n, name
        # a span's two clocks are read microseconds apart at each end; a
        # stall of the thread in between (a loaded host: 1 ms seen) moves
        # one and not the other, so 5% holds where a stall is small
        if s >= 0.05:
            assert tot[name] == pytest.approx(s, rel=0.05), name
    assert sum(tot.values()) == pytest.approx(
        sum(s for s, _ in spans_s.values()), rel=0.05)


def test_readers_of_the_spans(traced):
    timers, _, mnt = traced
    obs = dict(timers=timers, mnt=mnt)
    host = reader("part_driver.host_s_per_mnt")(obs)
    assert 0 < host * mnt <= timers["part_driver"][0]
    assert host == pytest.approx(
        sum(timers[k][0] for k in HOST_STAGES if k in timers) / mnt)
    assert 0 < reader("sw.useful_share")(obs) <= 100
    assert reader("sw.rounds_per_start")(obs) >= 1
    assert reader("state_save.s_per_mnt")(obs) * mnt == pytest.approx(
        timers["state_save"][0] + timers["journal_append"][0])
    assert timers["state_save"][1] == 2          # after align, after post
    # no card, no wait on it
    assert reader("sw.wait_s_per_mnt")(obs) is None


def test_readers_find_nothing_in_an_empty_run():
    obs = dict(jobs=[], phase_s={}, timers={}, device={}, mnt=1.0,
               sw_launches=0, sw_bound_s=0.0)
    for m in NEW_METRICS:
        assert reader(m)(obs) is None, m


# the long-read cell's flags (benchmark/configs/rrna-filter-longread.json)
CELL_FLAGS = ["-num_alignments", "1", "-fastx", "-aligned", "-other",
              "-threads", "8"]


def test_speculation_rounds(tmp_path, monkeypatch):
    """A job of the long-read cell's kind: 24 reads of 1,300-1,600 nt,
    all cut from members of 2 families of 20, the cell's flags.  With
    every job of a read offered in its first wave the engine applied 46
    of the 480 jobs it scored (``sw.useful_share`` 9.583%).  Offered in
    rounds from each read's cursor it applies the same 46 of far fewer,
    and every read that waited took at least one round."""
    db, reads = str(tmp_path / "db.fa"), str(tmp_path / "r.fa")
    seqs = testing.make_db(db, 40, n_families=2, len_range=(1300, 1600),
                           seed=15)
    testing.make_reads(reads, seqs, 24, len_range=(1300, 1600),
                       frac_db=1.0, seed=16)
    (tmp_path / "idx").mkdir()
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SMR_TPU_LOG", "0")
    monkeypatch.setattr(util, "_TIMERS_ON", True)
    monkeypatch.setattr(util, "TIMERS", {})
    assert tcli.main(["-ref", db, "-reads", reads] + CELL_FLAGS
                     + ["-idx-dir", str(tmp_path / "idx"),
                        "-workdir", str(tmp_path / "wd")]) == 0
    t = {k: list(v) for k, v in util.TIMERS.items()}
    assert t["sw_jobs_consumed"][1] == 46
    assert reader("sw.useful_share")(dict(timers=t)) >= 3 * 9.583
    rounds, starts = t["sw_fsm_rounds"][1], t["sw_fsm_starts"][1]
    assert rounds >= starts > 0
    assert reader("sw.rounds_per_start")(dict(timers=t)) == rounds / starts


def test_span_from_many_threads_loses_no_update(monkeypatch):
    monkeypatch.setattr(util, "_TIMERS_ON", True)
    monkeypatch.setattr(util, "TIMERS", {})
    n_threads, n_spans = 16, 200
    inner = [0.0] * n_threads

    def work(k):
        for _ in range(n_spans):
            with util.timed("shared"):
                t0 = time.perf_counter()
                sum(range(200))
                inner[k] += time.perf_counter() - t0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths)
    s, n = util.TIMERS["shared"]
    assert n == n_threads * n_spans
    assert s >= sum(inner)


# a synthetic trace, times in us: the card busy over [10, 30] and
# [65, 70] of a window [0, 100]; spans of the window's thread (tid 1)
# nested as a job's, one span of another thread, and the profiler's copy
# of a host span on a device lane
EVENTS = [
    ("kernel", "sw_fused_long_kernel", 10, 20, 7),
    ("gpu_memcpy", "Memcpy HtoD", 15, 30, 7),
    ("kernel", "sw_fused_kernel", 65, 70, 7),
    ("gpu_user_annotation", "smr.run_reports", 0, 100, 7),
    ("user_annotation", "bench.window", 0, 100, 1),
    ("user_annotation", "bench.job", 1, 99, 1),
    ("user_annotation", "smr.run_all", 2, 95, 1),
    ("user_annotation", "smr.run_align", 5, 60, 1),
    ("user_annotation", "smr.part_driver", 6, 58, 1),
    ("user_annotation", "smr.sw_wait", 40, 50, 1),
    ("user_annotation", "smr.run_reports", 72, 90, 1),
    ("user_annotation", "smr.trav_pump", 30, 40, 2),
    ("cpu_op", "aten::copy_", 15, 16, 1),
]


def test_idle_is_charged_to_the_innermost_span(tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [
            dict(ph="X", cat=c, name=n, ts=a, dur=b - a, pid=1, tid=t)
            for c, n, a, b, t in EVENTS]}, f)
    d = spans.reduce(*spans.load(path))
    want = {"outside": 7, "run_all": 15, "run_align": 3,
            "part_driver": 22, "sw_wait": 10, "run_reports": 18}
    assert d["idle_by_span"] == pytest.approx(
        {k: v / 1e6 for k, v in want.items()})
    assert list(d["idle_by_span"])[0] == "part_driver"   # largest first
    assert d["idle_in_align"] == pytest.approx(35.0)
    assert d["idle_outside_align"] == pytest.approx(40.0)
    # the two shares are device.idle_share, split
    dev = devtrace.reduce(*devtrace.load(path))
    assert d["idle_in_align"] + d["idle_outside_align"] == pytest.approx(
        reader("device.idle_share")(dict(device=dev)))
    assert "part_driver 0.000s" in spans.line(d)


def test_no_window_or_no_device_work_charges_nothing():
    ops = [("k", 1.0, 2.0)]
    assert spans.reduce(ops, [], None) == {}
    assert spans.reduce([], [], (0.0, 10.0, 1)) == {}
    d = spans.reduce(ops, [], (0.0, 10.0, 1))
    assert d["idle_by_span"] == {"outside": pytest.approx(9e-6)}
    assert d["idle_in_align"] == 0
