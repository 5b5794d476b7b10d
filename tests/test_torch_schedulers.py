"""The overlap scheduler's variants: the port's CLI against the JAX CLI.

The overlap scheduler (engine/align._run_part_overlapped) cuts a part's
batch into read-range slices and pipelines their host stages against
their SW waves; its opt-in variants (SMR_WAVE_GROUP, SMR_FLUSH_DEPTH,
SMR_PUMP_HELPER, SMR_GROUP_WORKERS, SMR_OVERLAP_THREADS,
SMR_PUMP_WORKERS) run those stages from one or several threads.  Reads
never interact within a part, so every setting, and the single-driver
sweep (SMR_OVERLAP=0), must write the JAX CLI's reports byte for byte.

The settings are those of tests/test_overlap.py plus SMR_OVERLAP=0,
SMR_OVERLAP_THREADS=2 and SMR_PUMP_WORKERS=2, on 2,000 seeded synthetic
reads (that file reads a dataset that is not in the repository).
OVERLAP_MIN_READS is lowered to 1,000 in both packages so the scheduler
engages.  The JAX CLI runs once, with its defaults: its own test holds
its output the same under every setting.  The port runs on
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

N_READS = 2000
REPORTS = ("aligned.blast", "aligned.fa", "other.fa", "otu_map.txt",
           "aligned_denovo.fa", "aligned.sam", "aligned.log")
SETTINGS = {
    "single": {"SMR_OVERLAP": "0"},
    "grp3": {"SMR_OVERLAP_SPLIT": "8", "SMR_WAVE_GROUP": "3"},
    "grp1": {"SMR_OVERLAP_SPLIT": "8", "SMR_WAVE_GROUP": "1"},
    "helper": {"SMR_OVERLAP_SPLIT": "6", "SMR_PUMP_HELPER": "1"},
    "workers2": {"SMR_OVERLAP_SPLIT": "8", "SMR_GROUP_WORKERS": "2"},
    "depth1": {"SMR_OVERLAP_SPLIT": "8", "SMR_FLUSH_DEPTH": "1"},
    "threads2": {"SMR_OVERLAP_SPLIT": "8", "SMR_OVERLAP_THREADS": "2"},
    "pump2": {"SMR_OVERLAP_SPLIT": "8", "SMR_PUMP_WORKERS": "2"},
}
KNOBS = sorted({k for env in SETTINGS.values() for k in env})


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
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(talign, "OVERLAP_MIN_READS", 1000)
    _clear_knobs(monkeypatch)
    for k, v in SETTINGS[name].items():
        monkeypatch.setenv(k, v)
    overlapped = []
    orig = talign._run_part_overlapped

    def spy(*a, **kw):
        overlapped.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(talign, "_run_part_overlapped", spy)
    wd = top / f"wd_{name}"
    assert tcli.main(argv(wd)) == 0
    # one index part, one batch: one overlapped run unless it is off
    assert len(overlapped) == (0 if name == "single" else 1)
    got = testing.read_outputs(str(wd / "out"), [str(wd)])
    for report in REPORTS:
        assert got[report] == want[report], report
