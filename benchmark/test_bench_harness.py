"""CPU tests of the benchmark: the generator, the files, the roofline
count, the plain reference and judge, a whole tiny run on the port's CPU
path, the control and the planted faults.  The card test runs only where
a card is present.

    python -m pytest -q benchmark/test_bench_harness.py
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import devtrace  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402
from reference import generate, gumbel, judge, roofline, sw  # noqa: E402

SEED = 2 ** 31 + 977          # past 32 signed bits, as the driver's are
# a mix that no cell uses yet, kept to the generator's tests: Nanopore
# cDNA (log-normal lengths, per-base errors; PERF.md's further cells)
ONT_LIKE = dict(reads_per_job=10000, rrna_share=0.05,
                lengths=dict(kind="lognormal", median=1000, sigma=0.7,
                             min=200, max=5000),
                rrna_errors=dict(error_rate=0.01, sub_share=0.5,
                                 ins_share=0.25))
# ALP's (lambda, K) for 2/-3, gaps 5 + 2k, uniform composition, as the
# port's ALP driver gives them (refstats.cpp:184-233's call)
ALP_UNIFORM = (0.6189338411473755, 0.3446431476547376)
# the short-read cell, held out of BENCHMARK.json for its host's spread
# (PERF.md), whose files the CPU runs use: short reads run fast there
SHORT = ("rrna-filter-illumina", "illumina-totalrna")


def traffic(name: str) -> dict:
    return run.load_json(os.path.join(BENCH, "traffic", name + ".json"))


def spec_of(config: str, mix: str) -> dict:
    """A cell of ``config`` under ``mix``, as ``run.load_cell`` makes one,
    whether or not ``BENCHMARK.json`` lists it."""
    bench = run.load_json(os.path.join(os.path.dirname(BENCH),
                                       "BENCHMARK.json"))
    return dict(
        cell=dict(name=mix, config=config, traffic=mix, chips=1),
        config=run.load_json(os.path.join(BENCH, "configs",
                                          config + ".json")),
        traffic=traffic(mix),
        end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
        per_layer=[m for m in bench["per_layer"] if "workloads" not in m])


def tiny(config: str, mix: str, reads: int) -> dict:
    """The files of a cell with the database and the jobs cut to a size
    the port's CPU path runs in seconds."""
    spec = spec_of(config, mix)
    spec["config"]["database"].update(n_seqs=120, n_families=6)
    spec["config"]["flags"] = [f if f != "8" else "2"
                               for f in spec["config"]["flags"]]
    spec["traffic"].update(reads_per_job=reads, pool_jobs=1)
    # a 4,000-pair Gumbel estimate, good to a few percent in lambda and
    # some tens in K: the limits of its numbers follow it here
    spec["config"]["gumbel_fit"] = dict(pairs=4000, length=300, seed=1)
    spec["traffic"]["limits"].update(lambda_rel_err=0.05, K_log_err=0.4)
    return spec


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    torch.set_num_threads(2)
    return str(tmp_path_factory.mktemp("bench_cache"))


def test_generator_is_deterministic_and_keeps_sizes():
    db = generate.make_db(dict(n_seqs=50, n_families=5, len_range=[300, 400],
                               divergence=0.08, db_seed=3))
    assert db.total_len == generate.make_db(
        dict(n_seqs=50, n_families=5, len_range=[300, 400], divergence=0.08,
             db_seed=3)).total_len
    for t in (traffic("illumina-totalrna"), ONT_LIKE,
              traffic("pacbio-fl16s")):
        a = generate.make_job(db, t, SEED, 2, 400)
        b = generate.make_job(db, t, SEED, 2, 400)
        c = generate.make_job(db, t, SEED + 1, 2, 400)
        assert generate.fastq_bytes(a, SEED, 2) == \
            generate.fastq_bytes(b, SEED, 2)
        assert generate.fastq_bytes(a, SEED, 2) != \
            generate.fastq_bytes(c, SEED + 1, 2)
        # the same rRNA count and, for random reads, the same lengths
        assert a.is_rrna.sum() == c.is_rrna.sum() == \
            round(400 * t["rrna_share"])
        la = sorted(len(s) for s, r in zip(a.seqs, a.is_rrna) if not r)
        lc = sorted(len(s) for s, r in zip(c.seqs, c.is_rrna) if not r)
        assert la == lc


def test_every_file_loads():
    bench = json.load(open(os.path.join(os.path.dirname(BENCH),
                                        "BENCHMARK.json")))
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"])
        assert spec["config"]["name"] == w["config"]
    for p in glob.glob(os.path.join(BENCH, "traffic", "*.json")):
        assert tuple(run.load_json(p)["limits"]) == judge.NUMBERS
    for m in bench["per_layer"]:
        assert run.load_reader(m["name"])(
            dict(jobs=[], phase_s={}, timers={}, device={}, mnt=1.0,
                 sw_launches=0, sw_bound_s=0.0)) is None
    names = {os.path.basename(p)[:-3]
             for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))}
    assert names == {m["name"] for m in bench["per_layer"]}


@pytest.mark.parametrize("d,readlen,reflen,que,ref", [
    (0, 150, 1548, (0, 150), (0, 154)),         # at the start: no head
    (10, 150, 1548, (0, 150), (6, 164)),        # edges 4 either side
    (1400, 150, 1548, (0, 140), (1396, 1540)),  # overhangs the end
    (-5, 150, 1548, (5, 150), (0, 149)),        # overhangs the start
    (-5, 1500, 1400, (5, 1405), (0, 1400)),     # longer than its reference
])
def test_sortmerna_window_geometry(d, readlen, reflen, que, ref):
    q, r = np.arange(readlen), np.arange(reflen)
    wq, wr = judge.sortmerna_window(q, r, d, 4)
    assert (wq[0], wq[-1] + 1) == que and len(wq) == que[1] - que[0]
    assert (wr[0], wr[-1] + 1) == ref and len(wr) == ref[1] - ref[0]


def test_roofline_on_hand_worked_shapes():
    # pair 0: 100 x 120 cells, begins at column 10, ends at row 79 and
    # column 109: 80 x 100 more; pair 1 found nothing
    ints = np.array([[100, 120, 30], [50, 60, 30]], np.int32)
    out = np.array([[150, 0], [10, -1], [109, -1], [0, -1], [79, 0]],
                   np.int32)
    assert roofline.fused_cells(ints, out) == 100 * 120 + 50 * 60 + 80 * 100
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    # 1e9 cells: 6e9 ops over 16.73 Tops; 1 GB over 3.35 TB/s is less
    assert roofline.bound_s(10 ** 9, 10 ** 9) == pytest.approx(
        6e9 / roofline.INT32_OPS_PER_S)
    assert roofline.bound_s(1, 3.35e12) == pytest.approx(1.0)


def _sw_cell_by_cell(q, r, go, ge):
    H = np.zeros((len(q) + 1, len(r) + 1), int)
    E = np.full_like(H, -10 ** 9)
    F = np.full_like(H, -10 ** 9)
    for i in range(1, len(q) + 1):
        for j in range(1, len(r) + 1):
            E[i, j] = max(E[i - 1, j] - ge, H[i - 1, j] - go)
            F[i, j] = max(F[i, j - 1] - ge, H[i, j - 1] - go)
            s = 2 if q[i - 1] == r[j - 1] else -3
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
    return H.max()


def test_plain_sw_against_cell_by_cell():
    rng = np.random.default_rng(5)
    qs, rs = [], []
    for k in range(24):
        r = rng.integers(0, 4, int(rng.integers(5, 40)), dtype=np.uint8)
        q = r[2:2 + int(rng.integers(3, 30))].copy() if k % 2 else \
            rng.integers(0, 4, int(rng.integers(3, 30)), dtype=np.uint8)
        if k % 3 == 0 and len(q) > 6:
            q = np.delete(q, 3)
        qs.append(q)
        rs.append(r)
    got = sw.best_scores(qs, rs, 2, -3, 5, 2, block_cells=100)
    assert list(got) == [_sw_cell_by_cell(q, r, 5, 2) for q, r in
                         zip(qs, rs)]
    # a gap of 3 costs 5 + 2 * 2: ACGTACGTAC / ACGTA---CGTAC...
    q = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1] * 2, np.uint8)
    r = np.concatenate([q[:10], [3, 3, 3], q[10:]]).astype(np.uint8)
    assert sw.best_scores([q], [r], 2, -3, 5, 2)[0] == 40 - 9


def test_search_space():
    f = np.full(4, 0.25)
    db = generate.Database(["a"], [np.tile(np.arange(4, dtype=np.uint8),
                                           250)])
    sp = judge.SearchSpace(db, f, 0.6, 0.3, 10, 1500, 1.0)
    expect = int(np.log(0.3 * 1000 * 1500) / 2.0)
    assert (sp.m, sp.n) == (1000 - expect, 1500 - 10 * expect)
    assert sp.minimal == int(np.log(1 / (0.3 * sp.m * sp.n)) / -0.6)


def test_gumbel_fit_recovers_a_known_law():
    # integer maxima with P(S >= x) = 1 - exp(-K m n e^(-lambda x))
    lam, K, m, n = 0.62, 0.34, 300, 400
    u = np.random.default_rng(3).random(40000)
    s = np.floor((np.log(K * m * n) - np.log(-np.log(u))) / lam)
    got = gumbel.fit(s, m, n)
    assert got[0] == pytest.approx(lam, rel=0.01)
    assert got[1] == pytest.approx(K, rel=0.1)


def test_gumbel_estimate_is_near_alp(tmp_path):
    f = np.full(4, 0.25)
    scoring = dict(match=2, mismatch=-3, gap_open=5, gap_ext=2)
    spec = dict(pairs=4000, length=300, seed=1)
    lam, K = gumbel.cached(str(tmp_path / "g.json"), f, scoring, spec)
    assert lam == pytest.approx(ALP_UNIFORM[0], rel=0.04)
    assert abs(np.log(K / ALP_UNIFORM[1])) < 0.4
    # kept, and made again only when what it was made from changes
    assert gumbel.cached(str(tmp_path / "g.json"), f, scoring, spec) == \
        (lam, K)
    assert gumbel.cached(str(tmp_path / "g.json"), f, scoring,
                         dict(spec, pairs=500)) != (lam, K)


def test_trace_reduction():
    ops = [("void (anonymous namespace)::sw_fused_kernel<1>(int)", 10, 20),
           ("Memcpy HtoD", 15, 30), ("sw_fused_long_kernel(int)", 65, 70)]
    spans = [("bench.window", 0, 100), ("bench.job", 6, 90),
             ("bench.run_align", 8, 80)]
    d = devtrace.reduce(ops, spans)
    assert d["busy_s"] == pytest.approx(25e-6)
    assert d["window_s"] == pytest.approx(100e-6)
    assert d["op_s"]["sw_fused_kernel"] == pytest.approx(10e-6)
    assert d["idle_gaps"][0] == ["run_align", pytest.approx(35e-6)]
    assert d["idle_gaps"][1] == ["state_other", pytest.approx(30e-6)]
    assert d["idle_gaps"][2][0] == "between_jobs"
    assert run.load_reader("sw_fused_roofline")(
        dict(device=d, sw_launches=2, sw_bound_s=5e-6)) == \
        pytest.approx(100 * 5 / 15)


def test_tiny_run_is_correct_and_prints_the_contract(cache):
    res = run.run_cell(tiny(*SHORT, 300), SEED, 0.1, False,
                       device="cpu", cache_root=cache)
    assert res["correct"], res["compared"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(res["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert tuple(res["compared"]) == judge.NUMBERS
    assert run.forbidden_modules() == []


def test_tiny_traced_run_reports_the_host_layers(cache):
    spec = tiny(*SHORT, 300)
    spec["traffic"].update(rrna_share=0.05)
    res = run.run_cell(spec, SEED + 1, 0.1, True, device="cpu",
                       cache_root=cache)
    assert res["correct"], res["compared"]
    host = {"prepare.s_per_job", "run_align.s_per_mnt", "reports.s_per_mnt",
            "state_other.s_per_mnt"}
    assert host <= set(res["metrics"])
    assert "sw_fused_roofline" not in res["metrics"]     # no card, no trace


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_control_and_faults_come_out_not_correct(cache, fault):
    # the tiny estimate cannot see the chip's 3% in lambda: here the
    # Gumbel fault is as far off as the tiny limits are wide, and more
    plant = faults.gumbel_off(1.1, 2.0) if fault == "gumbel_off" \
        else faults.FAULTS[fault]
    res = run.run_cell(tiny(*SHORT, 300), SEED, 0.1, False,
                       device="cpu", cache_root=cache, fault=plant)
    assert not res["correct"], res["compared"]
    assert res["failed"] == 0        # found wrong by the judge, not a crash
    failing = {k for k, v in res["compared"].items()
               if v["value"] > v["limit"]}
    # each fault fails the number that is there to catch it
    catch = {"clip_end": "window_gap_max", "gumbel_off": "lambda_rel_err",
             "saturate8": "evalue_log_err_max"}.get(fault)
    assert catch is None or catch in failing, failing


@pytest.mark.cuda
def test_trace_reads_device_time_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    P = torch.profiler
    with P.profile(activities=[P.ProfilerActivity.CPU,
                               P.ProfilerActivity.CUDA]) as prof:
        with P.record_function("bench.window"):
            x = torch.ones(1 << 24, device="cuda")
            for _ in range(20):
                x = x * 1.0001
            torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    d = devtrace.reduce(*devtrace.load(path))
    assert 0 < d["busy_s"] <= d["window_s"]
