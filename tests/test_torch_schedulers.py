"""The overlap scheduler's slice counts: the port's CLI against the JAX
CLI.

The overlap scheduler (engine/align._run_part_overlapped) cuts a part's
batch into read-range slices (OVERLAP_SLICES) and pumps the two halves
of them in turns on the native pool while the other half's SW waves are
on the device.  Reads never interact within a part, so at every slice
count -- even (equal halves), odd (unequal halves), the card's 24 -- and
in the single-driver sweep (a batch under OVERLAP_MIN_READS) the port
must write the JAX CLI's reports byte for byte, on 2,000 seeded
synthetic reads.  OVERLAP_MIN_READS is lowered to 1,000 in both packages
so the scheduler engages.  The JAX CLI runs once, with its defaults, the
scheduler's environment options cleared.  The port runs on
``SMR_TORCH_DEVICE=cpu``, i.e. the kernels' plain PyTorch versions.
"""

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.engine import align as jalign            # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.engine import align as talign      # noqa: E402
from sortmerna_tpu_torch.engine.part_driver import \
    NativePartDriver                                        # noqa: E402

N_READS = 2000
REPORTS = ("aligned.blast", "aligned.fa", "other.fa", "otu_map.txt",
           "aligned_denovo.fa", "aligned.sam", "aligned.log")
# slices a part's batch is cut into; None: the single-driver sweep
SETTINGS = {"single": None, **{f"slices{k}": k
                               for k in (2, 3, 5, 8, 13, 24, 32)}}
# the JAX package's scheduler options, cleared for its run
KNOBS = ("SMR_OVERLAP", "SMR_OVERLAP_SPLIT", "SMR_WAVE_GROUP",
         "SMR_FLUSH_DEPTH", "SMR_PUMP_HELPER", "SMR_GROUP_WORKERS",
         "SMR_OVERLAP_THREADS", "SMR_PUMP_WORKERS")


def _clear_knobs(mp):
    for k in KNOBS:
        mp.delenv(k, raising=False)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The DB, the reads, the argv of a run and the JAX CLI's reports.
    The index directory is written by the JAX CLI and read by the
    port's runs."""
    top = tmp_path_factory.mktemp("sched")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    seqs = testing.make_db(db, 200, n_families=20, len_range=(1400, 1500),
                           seed=11)
    testing.make_reads(reads, seqs, N_READS, seed=12)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")

    def argv(wd):
        return ["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS + \
            ["-idx-dir", str(idx), "-workdir", str(wd)]

    mp = pytest.MonkeyPatch()
    try:
        _clear_knobs(mp)
        mp.setattr(jalign, "OVERLAP_MIN_READS", 1000)
        wd = top / "wd_jax"
        assert jcli.main(argv(wd)) == 0
    finally:
        mp.undo()
    want = testing.read_outputs(str(wd / "out"), [str(wd)])
    assert set(want) == set(REPORTS)
    n_aligned = want["aligned.fa"].count(b">")
    assert 500 < n_aligned < N_READS        # non-degenerate
    return top, argv, want


@pytest.mark.parametrize("name", list(SETTINGS))
def test_scheduler_setting_matches_jax(workload, name, monkeypatch):
    top, argv, want = workload
    slices = SETTINGS[name]
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(talign, "OVERLAP_MIN_READS",
                        1000 if slices else N_READS + 1)
    if slices:
        monkeypatch.setitem(talign.OVERLAP_SLICES, "cpu", slices)
    overlapped, calls = [], []
    orig = talign._run_part_overlapped
    orig_pump = NativePartDriver.pump_many

    def spy(*a, **kw):
        overlapped.append(1)
        return orig(*a, **kw)

    def pump_spy(drvs):
        calls.append(len(drvs))
        return orig_pump(drvs)

    monkeypatch.setattr(talign, "_run_part_overlapped", spy)
    monkeypatch.setattr(NativePartDriver, "pump_many",
                        staticmethod(pump_spy))
    wd = top / f"wd_{name}"
    assert tcli.main(argv(wd)) == 0
    # one index part, one batch: one overlapped run unless it is off,
    # each pump on the pool a half of the slices at most
    assert len(overlapped) == (1 if slices else 0)
    if slices:
        half = -(-slices // 2)
        assert calls and max(calls) == half
    else:
        assert calls == []
    got = testing.read_outputs(str(wd / "out"), [str(wd)])
    for report in REPORTS:
        assert got[report] == want[report], report
