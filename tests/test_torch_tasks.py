"""Tasks 0-3 and the align journal's resume: the port against the JAX CLI.

Every run writes the verify recipe's reports for the same seeded
synthetic workload; each must be byte-equal to the JAX CLI's ``--task
4`` run (aligned.sam without @PG, aligned.log without its command, pid
and date lines):

* ``--task`` 0, 1, 2 in sequence over one workdir (align, then
  post-processing and the summary from the restored state, then the
  reports), and ``--task`` 3 then 2; ``--task 4`` for reference;
* a run hard-exited right after its 2nd journal unit (no clean-up, no
  consolidated state save), then resumed; and one whose journal has a
  torn record after its 3rd unit;
* a fresh align into a kvdb that holds a finished run is refused, and a
  journal written for other reads refuses to resume.
"""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.cli import parse_args              # noqa: E402
from sortmerna_tpu_torch.engine.run import run_all          # noqa: E402
from sortmerna_tpu_torch.engine.state import AlignJournal   # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
N_READS = 300
BATCH = 50                  # 6 journal units of 50 reads


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The workload, its index directory (written by the JAX run) and the
    JAX CLI's --task 4 reports."""
    top = tmp_path_factory.mktemp("tasks")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1500),
                           seed=91)
    testing.make_reads(reads, seqs, N_READS, seed=92)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")

    def argv(wd, *extra):
        return ["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS \
            + ["-idx-dir", str(idx), "-workdir", str(wd)] + list(extra)

    wd = top / "wd_jax"
    assert jcli.main(argv(wd, "-task", "4")) == 0
    want = testing.read_outputs(str(wd / "out"), [str(wd)])
    assert len(want) == 7 and want["aligned.fa"].count(b">") > 50
    return top, argv, want


def _same_as_jax(wd, want):
    got = testing.read_outputs(str(wd / "out"), [str(wd)])
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("tasks", [(4,), (0, 1, 2), (3, 2)],
                         ids=lambda t: "-".join(map(str, t)))
def test_task_sequence_matches_jax_task4(workload, tasks):
    top, argv, want = workload
    wd = top / ("wd_" + "-".join(map(str, tasks)))
    for task in tasks:
        run_all(parse_args(argv(wd, "-task", str(task))), device="cpu")
    _same_as_jax(wd, want)


def crash(argv, after: int):
    """Run ``argv`` in a child that hard-exits right after its ``after``-th
    journal unit (testing.CRASH_CHILD)."""
    p = subprocess.run(
        [sys.executable, "-c", testing.CRASH_CHILD, str(REPO), str(after),
         str(BATCH), "cpu"] + argv,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 9, p.stderr[-3000:]


def test_crash_resume_matches_jax(workload):
    top, argv, want = workload
    wd = top / "wd_crash"
    crash(argv(wd), 2)
    journal = AlignJournal(str(wd / "kvdb"))
    assert journal.exists()
    assert journal.meta() == {"batch_size": BATCH, "n_reads": N_READS}
    assert len(list(journal.scan())) == 1 + 2     # the header, 2 units
    assert not (wd / "out" / "aligned.log").exists()

    # resume in-process: picks up the journal, redoes only units 3-6
    ctx = run_all(parse_args(argv(wd)), device="cpu")
    _same_as_jax(wd, want)
    assert not journal.exists()     # consolidated into read_states.bin
    assert ctx.readstats.all_reads_count == N_READS


def test_resume_tolerates_torn_tail(workload):
    top, argv, want = workload
    wd = top / "wd_torn"
    crash(argv(wd), 3)
    # a crash mid-record: torn bytes after the last good record
    journal = AlignJournal(str(wd / "kvdb"))
    with open(journal.path, "ab") as f:
        f.write(AlignJournal.MAGIC.to_bytes(4, "little") + b"\x40" * 13)
    run_all(parse_args(argv(wd)), device="cpu")
    _same_as_jax(wd, want)


def test_fresh_align_refuses_nonempty_kvdb(workload):
    top, argv, _ = workload
    wd = top / "wd_twice"
    run_all(parse_args(argv(wd)), device="cpu")
    # completed state, no journal: align again -> reference-style error
    # (options.cpp:1313-1326 validate_kvdbdir), in both packages
    for main in (jcli.main, lambda a: run_all(parse_args(a), device="cpu")):
        with pytest.raises(SystemExit, match="is not empty"):
            main(argv(wd))


def test_journal_input_mismatch(workload):
    top, argv, _ = workload
    wd = top / "wd_mismatch"
    crash(argv(wd), 1)
    other_reads = top / "one.fasta"
    other_reads.write_text(">r0\nACGTACGTACGTACGTACGTACGT\n")
    argv2 = argv(wd)
    argv2[argv2.index("-reads") + 1] = str(other_reads)
    with pytest.raises(SystemExit, match="different input") as e:
        run_all(parse_args(argv2), device="cpu")
    assert "(300 reads vs 1)" in str(e.value)
