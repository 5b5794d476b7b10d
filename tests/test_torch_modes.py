"""The align modes the other port tests do not reach: the port's CLI
against the JAX package's, report for report.

Each case runs both CLIs on the same seeded synthetic workload (the port
on ``SMR_TORCH_DEVICE=cpu``) into their own workdirs over one index
directory; every file each writes must be byte-equal (gzip reports
decompressed, aligned.sam without @PG, aligned.log without its command,
pid and date lines): forward or reverse strand only, every alignment
(``-num_alignments 0``) with and without ``-full_search``, the first
accepted alignment with the default ``-best`` (``-num_alignments 1``),
``-print_all_reads`` with BLAST and SAM, single-end fastq in and out,
``-zip-out``, and reads of 120, 500 and 2,000 nt against one long
reference.  The port's CLI must also fail as the JAX CLI does (the same
exception and message) on a reference shorter than the seed, empty and
missing inputs, and paired files of different read counts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402

REPORTS = ["-fastx", "-other", "-sam", "-blast", "1 cigar qcov qstrand"]
LONG_LENS = (120, 500, 2000)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    top = tmp_path_factory.mktemp("modes")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1500),
                           seed=61)
    testing.make_reads(reads, seqs, 300, seed=62)
    # the same reads as single-end fastq, with seeded qualities
    rng = np.random.default_rng(63)
    lines = open(reads).read().split()
    with open(top / "reads.fastq", "w") as f:
        for h, s in zip(lines[::2], lines[1::2]):
            q = bytes(rng.integers(35, 74, len(s), dtype=np.uint8)).decode()
            f.write(f"@{h[1:]}\n{s}\n+\n{q}\n")
    # one long reference, reads of 120 / 500 / 2,000 nt cut from it
    # (about 0.5% substitutions), and random junk
    ref = rng.choice(testing.ALPHA, size=12000).tobytes()
    (top / "long_ref.fasta").write_text(">longref\n" + ref.decode() + "\n")
    with open(top / "long_reads.fasta", "w") as f:
        for i in range(6):
            ln = LONG_LENS[i % 3]
            off = int(rng.integers(0, len(ref) - ln))
            s = np.frombuffer(ref[off:off + ln], np.uint8).copy()
            at = rng.integers(0, ln, ln // 200)
            s[at] = rng.choice(testing.ALPHA, size=len(at))
            s = s.tobytes()
            f.write(f">long{i}\n"
                    f"{(testing.revcomp(s) if i % 2 else s).decode()}\n")
        for i in range(3):
            f.write(f">junk{i}\n"
                    f"{rng.choice(testing.ALPHA, 200).tobytes().decode()}\n")
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")
    return top


MODES = {
    "fwd": ["-F", "-num_alignments", "2", "-no-best"] + REPORTS,
    "rev": ["-R", "-num_alignments", "2", "-no-best"] + REPORTS,
    "num_alignments_0": ["-num_alignments", "0"] + REPORTS,
    "num_alignments_1": ["-num_alignments", "1"] + REPORTS,
    "full_search": ["-num_alignments", "0", "-full_search"] + REPORTS,
    "print_all_reads": ["-blast", "1", "-sam", "-print_all_reads"],
    "fastq_single": ["-fastx", "-other", "-blast", "1"],
    "zip_out": testing.VERIFY_FLAGS + ["-zip-out", "1"],
    "long_reads": testing.VERIFY_FLAGS,
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(workload, monkeypatch, mode):
    top = workload
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    if mode == "fastq_single":
        reads = str(top / "reads.fastq")
    elif mode == "long_reads":
        db, reads = str(top / "long_ref.fasta"), str(top / "long_reads.fasta")
    got = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        wd = top / f"wd_{mode}_{name}"
        assert main(["-ref", db, "-reads", reads] + MODES[mode]
                    + ["-idx-dir", str(top / "idx"),
                       "-workdir", str(wd)]) == 0
        got[name] = testing.read_reports(str(wd / "out"), [str(wd)])
    assert set(got["torch"]) == set(got["jax"])
    for report in got["jax"]:
        assert got["torch"][report] == got["jax"][report], report
    out = got["torch"]
    if mode == "print_all_reads":       # null rows for the unaligned reads
        assert b"\t*\t" in out["aligned.blast"]
        assert b"\t4\t*\t" in out["aligned.sam"]
        return
    if mode == "fastq_single":
        n_aligned = out["aligned.fq"].count(b"\n+\n")
        assert "other.fq" in out
    else:
        n_aligned = out["aligned.fa"].count(b">")
    assert n_aligned > (5 if mode == "long_reads" else 50)
    if mode == "zip_out":
        assert (top / f"wd_{mode}_torch" / "out" / "aligned.sam.gz").exists()


def _short_ref(top):
    p = top / "short_ref.fasta"
    p.write_text(">ok\n" + "ACGT" * 50 + "\n>short\nACGTACGTAC\n")
    return str(p)


def _empty(top):
    p = top / "empty.fasta"
    p.write_text("")
    return str(p)


def _paired(top):
    a, b = top / "pa.fasta", top / "pb.fasta"
    a.write_text(">x\n" + "ACGT" * 10 + "\n>y\n" + "ACGT" * 10 + "\n")
    b.write_text(">x\n" + "ACGT" * 10 + "\n")
    return str(a), str(b)


FAILURES = {
    "ref_shorter_than_seed": lambda t, db, r: ["-ref", _short_ref(t),
                                               "-reads", r],
    "empty_reads": lambda t, db, r: ["-ref", db, "-reads", _empty(t)],
    "empty_ref": lambda t, db, r: ["-ref", _empty(t), "-reads", r],
    "missing_reads": lambda t, db, r: ["-ref", db, "-reads",
                                       str(t / "nope.fa")],
    "paired_count_mismatch": lambda t, db, r: [
        "-ref", db, "-reads", _paired(t)[0], "-reads", _paired(t)[1]],
}


@pytest.mark.parametrize("case", list(FAILURES))
def test_failure_matches_jax(workload, monkeypatch, case):
    top = workload
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    args = FAILURES[case](top, str(top / "db.fasta"),
                          str(top / "reads.fasta"))
    raised = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        with pytest.raises(BaseException) as e:
            main(args + ["-idx-dir", str(top / f"idx_{case}_{name}"),
                         "-workdir", str(top / f"wd_{case}_{name}")])
        raised[name] = (type(e.value), str(e.value))
    assert raised["torch"] == raised["jax"]
    if case == "ref_shorter_than_seed":
        # the process: non-zero exit with the reference's wording
        p = subprocess.run(
            [sys.executable, "-m", "sortmerna_tpu_torch.cli"] + args
            + ["-workdir", str(top / "wd_short_cli")],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=dict(os.environ, SMR_TORCH_DEVICE="cpu"))
        assert p.returncode != 0
        assert "one of your sequences is shorter than the seed length 19" \
            in p.stderr + p.stdout
