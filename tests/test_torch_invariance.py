"""Partition invariance: the port's counterpart of
tests/test_stress_invariance.py, on 4,000 seeded synthetic reads (that
file reads a dataset that is not in the repository).

The per-read results (hit, alignments with their CIGARs, seed and SW
counts) and the counters must not depend on the execution geometry:

* the port's default ``run_align`` (on the cpu) writes the JAX package's
  reports, byte for byte, from the same per-read results and counters;
* batch size 7777 (the reference test's; one unit here) and 1777 (three
  units, odd boundaries), ``-threads 4``, and 4 read shards
  (``run_align_sharded`` over four cpu devices, a thread a shard) give
  the port's default results;
* the 4 shards also run with ``-device_probe``, where the shards share
  one device searcher (ops/seed_search.DeviceSeedSearcher); that run
  also equals the JAX package's ``run_align_sharded(ctx, mesh,
  n_shards=4, concurrent=True)`` under ``-device_probe``.
"""

import copy
import os

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

import jax                                                  # noqa: E402

from sortmerna_tpu import cli as jcli                       # noqa: E402
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
from sortmerna_tpu_torch.reports import summary as tsummary  # noqa: E402

N_READS = 4000
JAX = (jcli, jrun, jpost, jsummary)
PORT = (tcli, trun, tpost, tsummary)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """``opts_of(pkg, tag, *flags)``: a run's finalized options.  The
    index directory is written by the first run and read by the rest."""
    top = tmp_path_factory.mktemp("inv")
    db, reads = str(top / "db.fasta"), str(top / "reads.fasta")
    seqs = testing.make_db(db, 200, n_families=20, len_range=(1400, 1500),
                           seed=21)
    testing.make_reads(reads, seqs, N_READS, seed=22)
    idx = top / "idx"
    idx.mkdir()
    # a non-empty idx dir is used as given (the suite's conftest
    # redirects empty ones to its shared cache)
    (idx / ".keep").write_text("")

    def opts_of(pkg, tag, *flags):
        opts = pkg[0].parse_args(
            ["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS
            + ["-idx-dir", str(idx), "-workdir", str(top / tag)]
            + list(flags))
        opts.finalize()
        return opts

    return opts_of


def _align(pkg, opts, align):
    """prepare, then ``align(ctx)``: the context, its per-read results and
    a copy of its counters."""
    ctx = pkg[1].prepare(opts)
    align(ctx)
    rows = [(s.is_hit, s.is_done, s.hit_seeds, s.max_sw_count,
             [(a.ref_num, a.score1, a.ref_begin1, a.ref_end1,
               a.read_begin1, a.read_end1, list(a.cigar), a.strand)
              for a in s.alignments])
            for s in ctx.states]
    return ctx, rows, copy.deepcopy(vars(ctx.readstats))


def _reports(pkg, ctx):
    """Post-processing, the OTU map, the summary and the reports, as
    run_all writes them; the normalised reports."""
    _, run, post, summary = pkg
    otu = run.run_postprocess(ctx)
    out_dir = os.path.dirname(ctx.opts.aligned_pfx)
    os.makedirs(out_dir, exist_ok=True)
    post.write_otu_map(otu, os.path.join(out_dir, "otu_map.txt"))
    summary.write_summary(ctx.opts, ctx.refstats, ctx.readstats, len(otu))
    run.run_reports(ctx, otu)
    return testing.read_outputs(out_dir, [ctx.opts.workdir])


@pytest.fixture(scope="module")
def port_default(workload):
    ctx, rows, stats = _align(PORT, workload(PORT, "port_default"),
                              lambda c: trun.run_align(c, device="cpu"))
    assert sum(r[0] for r in rows) > 1000, "degenerate workload"
    return ctx, rows, stats


def test_default_run_matches_jax(workload, port_default):
    jctx, jrows, jstats = _align(JAX, workload(JAX, "jax_default"),
                                 jrun.run_align)
    tctx, trows, tstats = port_default
    assert trows == jrows
    assert tstats == jstats
    want = _reports(JAX, jctx)
    assert len(want) == 7
    assert _reports(PORT, tctx) == want


def _sharded_jax(ctx):
    jdist.run_align_sharded(ctx, jmesh.make_mesh(4), n_shards=4,
                            concurrent=True)


GEOMETRIES = {
    "batch7777": ((), lambda c: trun.run_align(c, batch_size=7777,
                                               device="cpu")),
    "batch1777": ((), lambda c: trun.run_align(c, batch_size=1777,
                                               device="cpu")),
    "threads4": (("-threads", "4"),
                 lambda c: trun.run_align(c, device="cpu")),
    "shards4": ((), lambda c: tdist.run_align_sharded(c, ["cpu"] * 4)),
    "shards4_device_probe": (
        ("-device_probe",),
        lambda c: tdist.run_align_sharded(c, ["cpu"] * 4)),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_partition_invariance(workload, port_default, name):
    flags, align = GEOMETRIES[name]
    if "device_probe" in flags and len(jax.devices("cpu")) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    _, base_rows, base_stats = port_default
    _, rows, stats = _align(PORT, workload(PORT, name, *flags), align)
    assert rows == base_rows
    assert stats == base_stats
    if "device_probe" in flags:
        _, jrows, jstats = _align(JAX, workload(JAX, "jax_" + name, *flags),
                                  _sharded_jax)
        assert rows == jrows
        assert stats == jstats
