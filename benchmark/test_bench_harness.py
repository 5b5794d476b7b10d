"""CPU tests of the benchmark: the generator, the files, the roofline
count, the plain reference and judge, a whole tiny run on the port's CPU
path (single-end, and paired against two databases), the control and
the planted faults, and the single-database single-end path held to the
bytes and numbers it gave before pairs and several databases.  The card
test runs only where a card is present.

    python -m pytest -q benchmark/test_bench_harness.py
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import json
import os
import sys
import tarfile

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
# the planned paired cell against nf-core's eight databases, whose files
# the paired CPU runs use
PAIRED = ("rrna-filter-nfcore-paired", "illumina-totalrna-paired")


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


def tiny_paired(pairs: int) -> dict:
    """The paired cell's files cut to its last two databases (18S and
    28S, which take most of its rRNA), 60 members each, their shares of
    the mix kept, and ``pairs`` pairs a job.  The tiny Gumbel estimate
    reads lambda to a few percent, so the two databases' G+C shares are
    set apart (0.5 and 0.7, lambda about 20% apart) for a fault that
    swaps their lambdas to show; its K reads about 0.37 from ALP's at
    G+C 0.7, and the K limit follows it here."""
    spec = spec_of(*PAIRED)
    conf = spec["config"]
    conf["database"] = [dict(d, n_seqs=60, n_families=3, gc=gc)
                        for d, gc in zip(conf["database"][6:8],
                                         (0.5, 0.7))]
    mix = spec["traffic"]["rrna_mix"]
    spec["traffic"]["rrna_mix"] = {d["name"]: mix[d["name"]]
                                   for d in conf["database"]}
    conf["flags"] = [f if f != "8" else "2" for f in conf["flags"]]
    conf["gumbel_fit"] = dict(pairs=4000, length=300, seed=1)
    spec["traffic"].update(reads_per_job=pairs, pool_jobs=1)
    spec["traffic"]["limits"].update(lambda_rel_err=0.05, K_log_err=0.6)
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


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def test_pairs_are_the_ends_of_one_fragment():
    specs = [dict(name=n, n_seqs=20, n_families=2, len_range=[300, 900],
                  divergence=0.08, gc=gc, db_seed=5 + k)
             for k, (n, gc) in enumerate((("x", 0.45), ("y", 0.6)))]
    dbs = generate.make_databases(specs)
    names = generate.database_names(specs)
    assert names == ["x", "y"] and dbs[1].names[0] == "y_fam0_0"
    t = dict(traffic(PAIRED[1]), rrna_errors=dict(subs=[0, 0]))
    del t["rrna_mix"]
    a = generate.make_pairs(dbs, names, t, SEED, 3, 400)
    b = generate.make_pairs(dbs, names, t, SEED, 3, 400)
    c = generate.make_pairs(dbs, names, t, SEED + 1, 3, 400)
    for m in (0, 1):
        assert generate.fastq_bytes(a.mates[m], SEED, 3, m + 1) == \
            generate.fastq_bytes(b.mates[m], SEED, 3, m + 1)
    assert a.mates[0].ids[7] == b"j3_r7/1" and a.mates[1].ids[7] == \
        b"j3_r7/2"
    # every seed: the same rRNA count, shared by the databases' nt
    assert a.is_rrna.sum() == c.is_rrna.sum() == 360
    assert list(np.bincount(a.db[a.is_rrna])) == \
        list(np.bincount(c.db[c.is_rrna]))
    share = np.bincount(a.db[a.is_rrna]) / 360
    assert share == pytest.approx([d.total_len / sum(
        e.total_len for e in dbs) for d in dbs], abs=1 / 360)
    assert (a.db[~a.is_rrna] == -1).all()
    # mate 1 opens the fragment and mate 2 closes it, reverse
    # complemented, on one strand of one member of its database
    rc = generate._revcomp
    for i in np.flatnonzero(a.is_rrna):
        m1, m2 = a.mates[0].seqs[i], a.mates[1].seqs[i]
        assert len(m1) == len(m2) == 150
        frag = [(k, s) for k, s in enumerate(
            generate.ACGT[x].tobytes().decode()
            for mem in dbs[a.db[i]].seqs for x in (mem, rc(mem)))
            if generate.ACGT[m1].tobytes().decode() in s]
        assert frag, i
        _, strand = frag[0]
        at = strand.find(generate.ACGT[m1].tobytes().decode())
        end = strand.find(generate.ACGT[rc(m2)].tobytes().decode(), at) \
            + 150
        assert 200 <= end - at <= 400 or end - at == len(strand)
    t["rrna_mix"] = {"y": 1.0}
    assert set(generate.make_pairs(dbs, names, t, SEED, 0, 50).db) == \
        {-1, 1}
    with pytest.raises(ValueError):
        generate.make_pairs(dbs, names, dict(t, rrna_mix={"z": 1}), SEED,
                            0, 50)


def test_judge_refuses_routing_it_does_not_implement():
    assert judge.output_names(["-paired_in", "-out2"], True) == (
        ["aligned_fwd.fq", "aligned_rev.fq"], ["other_fwd.fq",
                                               "other_rev.fq"])
    assert judge.output_names(["-paired_in"], True) == (["aligned.fq"],
                                                        ["other.fq"])
    for flags, paired in ((["-paired_out"], True), (["-sout"], True),
                          (["-paired"], False), (["-out2"], False)):
        with pytest.raises(ValueError):
            judge.output_names(flags, paired)


def test_coverage_counts_reads_on_the_first_database_that_aligns_them():
    # eight databases' rows in a job of 50,000 reads, and the bounds on
    # reads counted on an earlier database than their row's
    n, rows = 50000, [1162, 3938, 2664, 418, 10686, 7488, 7824, 10820]
    gain, moved = judge.moved_bound(8, 1.0)
    assert (gain, moved) == (11, 28) and judge.moved_bound(1, 1.0) == (0, 0)

    def lines(counts):
        return [(judge._pct(c, n),) for c in counts]

    def cm(counts, want_rows=rows, total=n, bounds=(gain, moved)):
        return judge.coverage_mismatches(lines(counts), want_rows, total,
                                         *bounds)

    assert cm(rows) == 0
    assert judge.fewest_moved(lines(rows), rows, n) == (0, 0)
    # a read with a row on a later database counted on the first: the
    # first line reads one more (seen on the card)
    assert cm([1163] + rows[1:]) == 0
    # one fewer on the sixth, the read counted on an earlier database
    # whose line rounds the same
    assert cm(rows[:5] + [7487] + rows[6:]) == 0
    # reads do not move to a later database, nor more than the bounds:
    # one database gains at most 11, all of them 28
    assert cm([1152] + rows[1:7] + [10830]) == 1
    assert cm([1162 + 40] + rows[1:4] + [10686 - 40] + rows[5:]) == 2
    assert cm([1162 + 20, 3938 + 20] + rows[2:4] + [10686 - 20, 7488 - 20]
              + rows[6:]) == 2
    spread = [c + (10 if k < 4 else -10) for k, c in enumerate(rows)]
    assert cm(spread) == 1
    # a printed 0.01% spans 5 reads: each line may hide 2 of the 10
    assert judge.fewest_moved(lines(spread), rows, n)[1] in range(32, 41)
    # two lines swapped: 2,776 reads moved, or none where the later
    # database counts fewer; a line missing; one database held exactly
    assert cm([3938, 1162] + rows[2:]) == 2
    assert judge.fewest_moved(lines([3938, 1162] + rows[2:]), rows,
                              n)[1] in range(2771, 2782)
    assert judge.fewest_moved(lines([1162, 3938]), [3938, 1162], n) == \
        (0, None)
    assert judge.coverage_mismatches(lines(rows)[:7], rows, n, gain,
                                     moved) == 1
    assert cm([1163], [1162], n, (0, 0)) == 1


def test_every_file_loads():
    bench = json.load(open(os.path.join(os.path.dirname(BENCH),
                                        "BENCHMARK.json")))
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"])
        assert spec["config"]["name"] == w["config"]
    for p in glob.glob(os.path.join(BENCH, "traffic", "*.json")):
        assert tuple(run.load_json(p)["limits"]) == judge.NUMBERS
    for p in glob.glob(os.path.join(BENCH, "configs", "*.json")):
        conf = run.load_json(p)
        assert conf["name"] == os.path.basename(p)[:-5]
        dbs = conf["database"]
        for d in [dbs] if isinstance(dbs, dict) else dbs:
            assert {"n_seqs", "n_families", "len_range", "divergence",
                    "db_seed"} <= set(d)
        names = generate.database_names(dbs)
        assert len(set(names)) == len(names)
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


def test_tiny_paired_run_against_two_databases_is_correct(cache):
    res = run.run_cell(tiny_paired(300), SEED, 0.1, False, device="cpu",
                       cache_root=cache)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 1
    # every number that counts a fault reads none
    assert all(res["compared"][k]["value"] == 0 for k in (
        "reads_misfiled", "log_mismatches", "blast_mismatches",
        "rrna_in_other", "window_gap_max", "bits_err_max"))


@pytest.mark.parametrize("fault", sorted(faults.PAIRED_FAULTS))
def test_paired_faults_fail_their_numbers(cache, fault):
    res = run.run_cell(tiny_paired(300), SEED, 0.1, False, device="cpu",
                       cache_root=cache,
                       fault=faults.PAIRED_FAULTS[fault])
    assert not res["correct"] and res["failed"] == 0, res["compared"]
    failing = {k for k, v in res["compared"].items()
               if v["value"] > v["limit"]}
    catch = {"mate_apart": {"reads_misfiled"},
             "first_gumbel": {"lambda_rel_err", "log_mismatches"},
             "coverage_swapped": {"log_mismatches"},
             "mate2_dropped": {"rrna_in_other"}}[fault]
    assert catch <= failing, failing


# The single-database single-end path as the harness gave it before
# pairs and several databases (commit 712e5f2): the sha256 of
# pacbio-fl16s's database file and of every job's FASTQ text at two
# seeds, of the tiny database of the saved run below, and the judge's
# numbers on that saved run: 40 reads of pacbio-fl16s against that
# database, run by the port on the CPU sound, under three planted
# faults, and with its outputs edited by hand ("tampered": a record
# moved to other, one written twice, one altered, a row dropped, three
# row fields and two log fields changed).
PARENT_DB = "f65ce3cdf9b6b861c3515a8cbb50a933c8f36702641bc687622e0a1cbe42d9d3"
PARENT_TINY_DB = \
    "74028187e043f40590e7e7dbfd01736128ea562cf0d41e5eae5fa298758a1d9c"
PARENT_JOBS = {
    SEED: ["81f7f3486463accf883b59fdf72e08e22a9be6ee2d835ac86da81f67b9990c22",
           "c91dbd58dafb5c0937f2eff92ee8507a3e5e0dc0ac5bfa84f4233eba020efd2a",
           "3bb06633ad9a2694a34ed94fc5e5cc053a4672572308181d44f07b975fb8d924",
           "94f799f7c4a5b69643f696a1b0aec15e13719e674eb2040da34b01c9a52762e7"],
    5000000011: [
        "bfe240091c116a81670728c501c5283f9da3f8eea744c77b52e2873d746a342f",
        "083227e0afd1a183c29fd0fe1aa7c254a441d6e6a925af6ab2f0a890b62a92e3",
        "074cd8626d9040ed17db01f0b940628cbea8caf1e9f3e0b19d0d16c437ae482e",
        "0c7a5376f8e06683bfdcc6cd644808d1ec397e112ec80d64e13f3e8c12f21d60"]}
_SOUND = dict(reads_misfiled=0, log_mismatches=0, rrna_in_other=0,
              blast_mismatches=0, window_gap_max=0, evalue_log_err_max=0.0,
              bits_err_max=0, lambda_rel_err=9.022151264492795e-05,
              K_log_err=0.005916753071371403, rows_checked=40, rows=40)
PARENT_NUMBERS = {
    "sound": _SOUND,
    "saturate8": dict(_SOUND, evalue_log_err_max=1902.8089919707054,
                      bits_err_max=2549),
    "clip_end": dict(_SOUND, window_gap_max=384),
    "gumbel_off": dict(_SOUND, lambda_rel_err=0.09990107947240445,
                       K_log_err=0.6872304274885739),
    "tampered": dict(_SOUND, reads_misfiled=2, log_mismatches=4,
                     rrna_in_other=1, blast_mismatches=3, bits_err_max=7,
                     K_log_err=0.1387270524372975, rows_checked=38,
                     rows=38)}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def test_single_database_files_are_the_parents(tmp_path):
    spec = spec_of("rrna-filter-longread", "pacbio-fl16s")
    paths = run.ensure_databases(spec["config"], str(tmp_path / "c"))
    assert [os.path.basename(p) for p in paths] == ["db.fasta"]
    assert _sha(open(paths[0], "rb").read()) == PARENT_DB
    db = generate.read_fasta(paths[0])
    for seed, want in PARENT_JOBS.items():
        pool = run.make_pool([db], ["db"], spec["traffic"], seed,
                             str(tmp_path))
        got = []
        for k, (files, is_rrna, n, nt) in enumerate(pool):
            assert files == [str(tmp_path / f"job{k}.fq.gz")] and n == 10000
            with gzip.open(files[0], "rb") as f:
                got.append(_sha(f.read()))
        assert got == want
    # the CLI call: one -ref, one -reads, as before
    argv = []
    run.run_job(argv.extend, paths, pool[0][0], "wd", "idx", ["-x"])
    assert argv == ["-ref", paths[0], "-reads", pool[0][0][0], "-x",
                    "-idx-dir", "idx", "-workdir", "wd"]
    assert run.gumbel_path("c", paths[0]) == os.path.join("c",
                                                          "ref_gumbel.json")


@pytest.mark.parametrize("variant", sorted(PARENT_NUMBERS))
def test_judge_gives_the_parents_numbers_on_a_saved_run(tmp_path, variant):
    spec = spec_of("rrna-filter-longread", "pacbio-fl16s")
    conf = spec["config"]
    conf["database"].update(n_seqs=120, n_families=6)
    generate.write_fasta(generate.make_db(conf["database"]),
                         str(tmp_path / "db.fasta"))
    assert _sha((tmp_path / "db.fasta").read_bytes()) == PARENT_TINY_DB
    with tarfile.open(os.path.join(BENCH, "golden",
                                   "pacbio-tiny.tar.gz")) as tar:
        tar.extractall(tmp_path, filter="data")
    is_rrna = np.array(json.loads((tmp_path / "is_rrna.json").read_text()),
                       bool)
    jobs = [dict(fastq=[str(tmp_path / "job0.fq.gz")],
                 out=str(tmp_path / variant), is_rrna=is_rrna)]
    nums = judge.judge(jobs, [generate.read_fasta(str(tmp_path /
                                                      "db.fasta"))],
                       conf["flags"] + conf["report_flags"],
                       conf["scoring"], conf["evalue"], conf["edges"],
                       2048, SEED, [ALP_UNIFORM])
    assert nums == PARENT_NUMBERS[variant]


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
