"""The overlap scheduler on the native pool: the port's CLI
against the JAX CLI.

The overlap scheduler (engine/align._run_part_overlapped) pumps half of
a part's slices at once on one persistent pool of ``-threads`` native
workers (native/pool.cpp, ``trav_pump_many``) while the other half's
waves are on the device.  Reads never interact within a part, so at any
pool width and slice count (OVERLAP_SLICES) the reports must be those of
the single-driver sweep (a batch under OVERLAP_MIN_READS) and of the JAX
CLI, byte for byte.  The job is paired (``-paired_in -out2``) against two databases,
so the second database's units import the states the first left, on
the pool too.  OVERLAP_MIN_READS is lowered to 1,000 in both packages so
the scheduler engages; the port runs on ``SMR_TORCH_DEVICE=cpu``.

Also: with the port's spans on, the pool's busy seconds are above 0 and
at most its capacity (the calls' wall times the width), and a seed probe
called from inside a pool task runs inline, with the probe's output.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.engine import align as jalign            # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import native, testing, util       # noqa: E402
from sortmerna_tpu_torch.engine import align as talign      # noqa: E402
from sortmerna_tpu_torch.engine.part_driver import \
    NativePartDriver                                        # noqa: E402
from sortmerna_tpu_torch.index import builder as tbuilder   # noqa: E402
from sortmerna_tpu_torch.ops.seed_probe import SeedSearcher  # noqa: E402

N_PAIRS = 1000
# the JAX package's scheduler options, cleared for its run
KNOBS = ("SMR_OVERLAP", "SMR_OVERLAP_SPLIT", "SMR_WAVE_GROUP",
         "SMR_FLUSH_DEPTH", "SMR_PUMP_HELPER", "SMR_GROUP_WORKERS",
         "SMR_OVERLAP_THREADS", "SMR_PUMP_WORKERS")


def _clear_knobs(mp):
    for k in KNOBS:
        mp.delenv(k, raising=False)


def _reports(wd):
    """The run's reports, aligned.log without its -threads value."""
    got = testing.read_reports(str(wd / "out"), [str(wd)])
    got["aligned.log"] = re.sub(r"threads = \d+", "threads = <n>",
                                got["aligned.log"])
    return got


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The databases, the reads, the argv of a run, and the reports of
    the JAX CLI and of the port's single-driver sweep.  The index
    directory is written by the JAX CLI and read by the port's runs."""
    top = tmp_path_factory.mktemp("pool")
    db1, db2 = str(top / "db1.fasta"), str(top / "db2.fasta")
    s1 = testing.make_db(db1, 40, n_families=5, len_range=(1300, 1500),
                         seed=41, name="a")
    s2 = testing.make_db(db2, 24, n_families=6, len_range=(1100, 1300),
                         divergence=0.18, seed=42, name="b")
    r1, r2 = str(top / "r_1.fasta"), str(top / "r_2.fasta")
    testing.make_paired_reads(r1, r2, s1 + s2, N_PAIRS, seed=43)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")

    def argv(wd, threads=None):
        return (["-ref", db1, "-ref", db2, "-reads", r1, "-reads", r2,
                 "-fastx", "-other", "-paired_in", "-out2", "-sam",
                 "-blast", "1 cigar qcov qstrand", "-num_alignments", "2",
                 "-idx-dir", str(idx), "-workdir", str(wd)]
                + (["-threads", str(threads)] if threads else []))

    with pytest.MonkeyPatch.context() as mp:
        _clear_knobs(mp)
        mp.setattr(jalign, "OVERLAP_MIN_READS", 1000)
        wd = top / "wd_jax"
        assert jcli.main(argv(wd)) == 0
        want = _reports(wd)
        mp.setenv("SMR_TORCH_DEVICE", "cpu")
        mp.setattr(talign, "OVERLAP_MIN_READS", 2 * N_PAIRS + 1)
        wd = top / "wd_single"
        assert tcli.main(argv(wd)) == 0
        single = _reports(wd)
    assert "threads = <n>" in want["aligned.log"]
    assert {"aligned_fwd.fa", "aligned_rev.fa", "other_fwd.fa",
            "other_rev.fa", "aligned.blast", "aligned.sam"} <= set(want)
    n_aligned = want["aligned_fwd.fa"].count(b">")
    assert 200 < n_aligned < N_PAIRS            # non-degenerate
    return dict(top=top, argv=argv, db=db1, reads=r1, want=want,
                single=single)


def _pooled_run(workload, monkeypatch, threads, slices, name):
    """The port's CLI through the overlap scheduler at ``threads`` and
    ``slices``: (its reports, the slice counts of its pump_many calls)."""
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(talign, "OVERLAP_MIN_READS", 1000)
    monkeypatch.setitem(talign.OVERLAP_SLICES, "cpu", slices)
    calls = []
    orig = NativePartDriver.pump_many

    def spy(drvs):
        calls.append(len(drvs))
        return orig(drvs)

    monkeypatch.setattr(NativePartDriver, "pump_many", staticmethod(spy))
    wd = workload["top"] / name
    assert tcli.main(workload["argv"](wd, threads)) == 0
    return _reports(wd), calls


def test_single_driver_matches_jax(workload):
    assert workload["single"] == workload["want"]


@pytest.mark.parametrize("slices", [2, 8])
@pytest.mark.parametrize("threads", [1, 2, 8])
def test_pooled_default_matches_jax(workload, monkeypatch, threads,
                                    slices):
    got, calls = _pooled_run(workload, monkeypatch, threads, slices,
                             f"wd_t{threads}_s{slices}")
    # every unit pumps its two halves on the pool, half the slices a call
    assert calls and max(calls) == slices // 2
    assert sorted(got) == sorted(workload["want"])
    for report in workload["want"]:
        assert got[report] == workload["want"][report], report
        assert got[report] == workload["single"][report], report


def test_pool_busy_within_capacity(workload, monkeypatch):
    monkeypatch.setattr(util, "_TIMERS_ON", True)
    monkeypatch.setattr(util, "TIMERS", {})
    got, calls = _pooled_run(workload, monkeypatch, 2, 8, "wd_timers")
    assert got == workload["want"]
    busy, cap = util.TIMERS["pump_pool_busy"], util.TIMERS["pump_pool_cap"]
    assert busy[1] == cap[1] == util.TIMERS["trav_pump"][1] == len(calls)
    assert 0 < busy[0] <= cap[0]


def test_probe_inside_a_pool_task_runs_inline(workload):
    """A probe of ``-threads 8`` called from a pool task runs every chunk
    on its own thread (counted by ``pool_counts``) and returns what it
    returns when it runs on the pool."""
    lib = native.get_lib()
    part = tbuilder.build_index(workload["db"]).parts[0]
    w1, w2 = testing.read_windows(workload["reads"], 18, 3000, seed=7)
    searcher = SeedSearcher(part, threads=8)
    counts = np.zeros(3, np.int64)

    def pool_counts():
        lib.pool_counts(counts.ctypes.data)
        return counts.tolist()

    d0, i0, _ = pool_counts()
    want = searcher.search_windows(w1, w2)
    d1, i1, workers = pool_counts()
    assert (d1 - d0, i1 - i0, workers) == (1, 0, 7)
    assert len(want[0]) > 1000
    got = {}

    @ctypes.CFUNCTYPE(None, ctypes.c_int64)
    def task(i):
        got[i] = searcher.search_windows(w1, w2)

    lib.pool_run(4, 4, ctypes.cast(task, ctypes.c_void_p))
    d2, i2, workers = pool_counts()
    # one job on the pool (now 3 workers), each task's probe inline
    assert (d2 - d1, i2 - i1, workers) == (1, 4, 3)
    assert sorted(got) == [0, 1, 2, 3]
    for hw, hid in got.values():
        assert np.array_equal(hw, want[0]) and np.array_equal(hid, want[1])


def test_pool_under_concurrent_callers():
    """More callers than cores, at pool widths that keep resizing the
    pool, each running jobs of 1 to 40 tasks: every task of every job
    runs once, and a call returns only once all its tasks have."""
    import sys
    import threading
    lib = native.get_lib()
    errors = []

    def caller(c):
        try:
            rng = np.random.default_rng(c)
            for _ in range(25):
                n = int(rng.integers(1, 41))
                ran = [0] * n

                @ctypes.CFUNCTYPE(None, ctypes.c_int64)
                def task(i):
                    ran[i] += 1

                lib.pool_run(int(rng.choice([1, 2, 3, 8, 16])), n,
                             ctypes.cast(task, ctypes.c_void_p))
                if ran != [1] * n:
                    errors.append((c, ran))
        except BaseException as e:  # noqa: BLE001
            errors.append((c, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(c,))
                   for c in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
