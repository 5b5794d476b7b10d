"""parallel/ on torch devices and torch.distributed: the port against the
JAX package on its 8 virtual CPU devices (tests/conftest.py).

* ``sharded_sw_step`` over 4 devices (``["cpu"] * 4``) against the JAX
  function on a 4-device mesh: the same scores, ends and ``n_pass``, at
  batch sizes that are not multiples of 4;
* read shards: ``run_align_sharded`` with 3 shards, every wave block split
  over 3 devices by ``MeshSwBackend``, then the normal post-processing,
  reports and summary -- against the JAX package's same run on a 3-device
  mesh and its plain CLI run: reports byte-equal, counters equal;
* multi-host: two processes of the port's CLI joined by gloo on
  127.0.0.1 (``SMR_COORD`` / ``SMR_NPROCS`` / ``SMR_PROC_ID``), paired
  reads over two databases split into several index parts, with and
  without ``-zip-out``: process 0's merged reports (decompressed) equal a
  single-process JAX CLI run's, and no section file is left;
* the refusals: ``--task 2`` under ``SMR_NPROCS=2``, and a multi-process
  run without its coordinator; a single-process run joins no group.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

import jax                                                  # noqa: E402

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.constants import scoring_matrix_5x5      # noqa: E402
from sortmerna_tpu.engine import postprocess as jpost       # noqa: E402
from sortmerna_tpu.engine import run as jrun                # noqa: E402
from sortmerna_tpu.parallel import dist as jdist            # noqa: E402
from sortmerna_tpu.parallel import mesh as jmesh            # noqa: E402
from sortmerna_tpu.reports import summary as jsummary       # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.engine import postprocess as tpost  # noqa: E402
from sortmerna_tpu_torch.engine import run as trun          # noqa: E402
from sortmerna_tpu_torch.parallel import dist as tdist      # noqa: E402
from sortmerna_tpu_torch.parallel import mesh as tmesh      # noqa: E402
from sortmerna_tpu_torch.reports import summary as tsummary  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
MAT = scoring_matrix_5x5(2, -3, 0)


@pytest.mark.parametrize("B", [203, 3])
def test_sharded_sw_step_matches_jax(B):
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    rng = np.random.default_rng(B)
    Q, _, R, _, qlen, rlen = (a[:B] for a in testing.scan_tiles(
        rng, max(B, 4), 64, 96))
    minimal = rng.integers(0, 40, B).astype(np.int32)
    want = jmesh.sharded_sw_step(Q, qlen, R, rlen, MAT, minimal, 5, 2,
                                 jmesh.make_mesh(4))
    got = tmesh.sharded_sw_step(Q, qlen, R, rlen, MAT, minimal, 5, 2,
                                tmesh.make_mesh(devices=["cpu"] * 4))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.int32 and g.shape == (B,)
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] and (B < 10 or 0 < got[3] < B)


def test_make_mesh_never_substitutes_the_cpu(monkeypatch):
    assert tmesh.make_mesh(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tmesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="is_available"):
        tdist.MeshSwBackend(MAT, 5, 2, ["cuda:0"])


@pytest.fixture(scope="module")
def two_db(tmp_path_factory):
    """Paired reads over two databases; -m 0.2 splits them into 3 and 2
    index parts.  The index directory is written by the JAX package's
    first run and read by every later one."""
    top = tmp_path_factory.mktemp("par")
    db1, db2 = str(top / "db1.fasta"), str(top / "db2.fasta")
    s1 = testing.make_db(db1, 40, n_families=5, len_range=(1300, 1500),
                         seed=41, name="a")
    s2 = testing.make_db(db2, 24, n_families=6, len_range=(1100, 1300),
                         divergence=0.18, seed=42, name="b")
    r1, r2 = str(top / "r_1.fasta"), str(top / "r_2.fasta")
    testing.make_paired_reads(r1, r2, s1 + s2, 150, seed=43)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")

    def argv(wd, *extra):
        return ["-ref", db1, "-ref", db2, "-reads", r1, "-reads", r2,
                "-fastx", "-other", "-paired_in", "-sam",
                "-blast", "1 cigar qcov qstrand", "-otu_map",
                "-de_novo_otu", "-m", "0.2", "-idx-dir", str(idx),
                "-workdir", str(wd)] + list(extra)

    return top, argv


def _sharded_run(run, post, summary, dist, opts, devices, backend):
    """prepare, the sharded align, then post-processing, the OTU map, the
    summary and the reports, as run_all does them."""
    opts.finalize()
    ctx = run.prepare(opts)
    dist.run_align_sharded(ctx, devices, sw_backend=backend)
    otu = run.run_postprocess(ctx)
    out_dir = os.path.dirname(opts.aligned_pfx)
    os.makedirs(out_dir, exist_ok=True)
    post.write_otu_map(otu, os.path.join(out_dir, "otu_map.txt"))
    summary.write_summary(opts, ctx.refstats, ctx.readstats, len(otu))
    run.run_reports(ctx, otu)
    return ctx


def test_mesh_backend_sharded_align_matches_jax(two_db, monkeypatch):
    if len(jax.devices("cpu")) < 3:
        pytest.skip("needs 3 virtual CPU devices")
    top, argv = two_db
    wds = {k: top / f"wd_{k}" for k in ("plain", "jax", "torch")}
    assert jcli.main(argv(wds["plain"])) == 0
    mesh = jmesh.make_mesh(3)
    jctx = _sharded_run(jrun, jpost, jsummary, jdist,
                        jcli.parse_args(argv(wds["jax"])), mesh,
                        jdist.MeshSwBackend(MAT, 5, 2, mesh))
    assert sum(len(b.parts) for b in jctx.indexes) == 5

    calls, slices = [], []
    orig_call = tdist.MeshSwBackend._device_call
    orig_fused = tdist.sw_fused

    def device_call(self, buf, B, lq, lr):
        calls.append(B)
        return orig_call(self, buf, B, lq, lr)

    def fused(buf, mat, B, *a):
        slices.append(B)
        return orig_fused(buf, mat, B, *a)

    monkeypatch.setattr(tdist.MeshSwBackend, "_device_call", device_call)
    monkeypatch.setattr(tdist, "sw_fused", fused)
    devices = ["cpu"] * 3
    tctx = _sharded_run(trun, tpost, tsummary, tdist,
                        tcli.parse_args(argv(wds["torch"])), devices,
                        tdist.MeshSwBackend(MAT, 5, 2, devices))
    # every block went out in slices, at most one a device, that cover it
    assert calls and sum(slices) == sum(calls)
    assert len(slices) > len(calls) and len(slices) <= 3 * len(calls)

    got = {k: testing.read_outputs(str(wd / "out"), [str(wd)])
           for k, wd in wds.items()}
    assert len(got["plain"]) == 7
    assert got["jax"] == got["plain"]
    assert got["torch"] == got["jax"]
    for f in ("num_aligned", "num_short", "num_denovo", "n_yid_ycov",
              "n_yid_ncov", "n_nid_ycov", "reads_matched_per_db",
              "total_otu"):
        assert getattr(tctx.readstats, f) == getattr(jctx.readstats, f), f
    assert all(c > 0 for c in tctx.readstats.reads_matched_per_db)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("zip_out", [False, True], ids=["plain", "zip"])
def test_multihost_cli_matches_jax(two_db, tmp_path, monkeypatch, zip_out):
    top, argv = two_db
    extra = ["-zip-out", "1"] if zip_out else []
    base = tmp_path / "base"
    monkeypatch.delenv("SMR_NPROCS", raising=False)
    assert jcli.main(argv(tmp_path / "wd_base", "-aligned",
                          str(base / "aligned"), "-other",
                          str(base / "other"), *extra)) == 0

    shared = tmp_path / "shared"
    env = dict(os.environ, SMR_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               SMR_COORD=f"127.0.0.1:{_free_port()}", SMR_NPROCS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sortmerna_tpu_torch.cli",
         *argv(tmp_path / f"wd{pid}", "-aligned", str(shared / "aligned"),
               "-other", str(shared / "other"), *extra)],
        env=dict(env, SMR_PROC_ID=str(pid)), cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            p.kill()

    want = testing.read_reports(str(base))
    got = testing.read_reports(str(shared))
    names = {"aligned.blast", "aligned.sam", "aligned.fa", "other.fa",
             "aligned_denovo.fa", "otu_map.txt", "aligned.log"}
    assert set(want) == names
    assert (base / "aligned.fa.gz").exists() == zip_out
    # no section file is left beside the merged reports
    assert set(got) == names
    for name in sorted(names):
        assert got[name] == want[name], name
    assert b"\tb" in got["aligned.sam"] and b"\ta" in got["aligned.sam"]


def test_multihost_refuses_task_split(two_db, monkeypatch):
    top, argv = two_db
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SMR_NPROCS", "2")
    monkeypatch.setenv("SMR_PROC_ID", "0")
    monkeypatch.setenv("SMR_COORD", f"127.0.0.1:{_free_port()}")
    with pytest.raises(SystemExit, match="single-host workflow"):
        tcli.main(argv(top / "wd_task2", "-task", "2"))
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_init_multihost_needs_its_coordinator(monkeypatch):
    for k in ("SMR_COORD", "SMR_PROC_ID", "SMR_NPROCS"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_multihost() == (0, 1)
    monkeypatch.setenv("SMR_NPROCS", "2")
    with pytest.raises(SystemExit, match="SMR_COORD"):
        tdist.init_multihost()
    monkeypatch.setenv("SMR_COORD", "127.0.0.1:1")
    with pytest.raises(SystemExit, match="SMR_PROC_ID"):
        tdist.init_multihost()


def test_run_align_sharded_one_shard_equals_run_align(two_db):
    """One device: run_align_sharded aligns every read as one shard and
    equals the plain align, states and counters."""
    top, argv = two_db
    ctxs = []
    for name in ("a", "b"):
        opts = tcli.parse_args(argv(top / f"wd_one_{name}"))
        opts.finalize()
        ctxs.append(trun.prepare(opts))
    trun.run_align(ctxs[0], device="cpu")
    tdist.run_align_sharded(ctxs[1], ["cpu"])
    a, b = (c.readstats for c in ctxs)
    assert (a.num_aligned, a.reads_matched_per_db) == \
        (b.num_aligned, b.reads_matched_per_db) and a.num_aligned > 0
    assert [(s.is_hit, [x.score1 for x in s.alignments])
            for s in ctxs[0].states] == \
        [(s.is_hit, [x.score1 for x in s.alignments])
         for s in ctxs[1].states]
