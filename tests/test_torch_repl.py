"""The -cmd session (engine/repl.py): the port's against the JAX package's.

One command stream goes to both packages' ``CmdSession`` on the same
seeded synthetic workload -- reads looked up by ordinal and by id (and
one that is absent), the part's reference range, the index part's
summary, an 18-mer cut from the database, one absent from it, a bad
k-mer, an index part out of range, an unknown command, a blank line,
and ``exit`` before a command that must not run.  The stdout of the two
sessions must be byte-equal; so must that of the two CLIs run with
``-cmd`` on the same stream (stdin).
"""

import contextlib
import io
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.engine.repl import CmdSession as JSession  # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.engine import repl as trepl        # noqa: E402


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    top = tmp_path_factory.mktemp("repl")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1500),
                           seed=81)
    testing.make_reads(reads, seqs, 300, seed=82)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")
    kmer = seqs[3][100:118].decode()
    script = "\n".join([
        "read --id=0", "read --id=7", "read --id=0_299",
        "read --id=123456", "", "ref --idx=0", "index --idx=0",
        f"index --idx=0 --kmer={kmer}", f"index --idx=0 --kmer={kmer[:17]}T",
        "index --idx=0 --kmer=" + "A" * 18,
        "index --idx=0 --kmer=NOTAVALIDKMER",
        "index --idx=0 --part=5", "ref --idx=3", "bogus_command --x=1",
        "exit", "read --id=1"]) + "\n"
    return top, db, reads, str(idx), script, kmer


def _argv(top, db, reads, idx, name):
    return ["-ref", db, "-reads", reads, "-idx-dir", idx,
            "-workdir", str(top / name), "-cmd"]


def test_cmd_session_matches_jax(workload):
    top, db, reads, idx, script, kmer = workload
    outs = {}
    for name, parse, session in (("jax", jcli.parse_args, JSession),
                                 ("torch", tcli.parse_args,
                                  trepl.CmdSession)):
        opts = parse(_argv(top, db, reads, idx, f"wd_s_{name}"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            session(opts).run(io.StringIO(script))
        outs[name] = buf.getvalue()
    assert outs["torch"] == outs["jax"]
    out = outs["torch"]
    # the facts the commands inspect are there, and every error was
    # reported without ending the session
    assert "id=0_7 " in out and "read 0_123456 not found" in out
    assert "occurrences=" in out and "18-mer not present" in out
    assert "need an 18-character ACGT k-mer" in out
    assert out.count("error: ") == 2 and "unknown command: bogus_command" \
        in out
    assert "id=0_1 " not in out                 # after exit


def test_cli_cmd_matches_jax(workload, monkeypatch):
    top, db, reads, idx, script, _ = workload
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(script))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(_argv(top, db, reads, idx, f"wd_c_{name}")) == 0
        outs[name] = buf.getvalue()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].startswith("sortmerna-tpu interactive session.")
    # a session aligns nothing: no reports
    assert not os.path.exists(top / "wd_c_torch" / "out" / "aligned.log")
