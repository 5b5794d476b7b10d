"""nf-core/rnaseq's rRNA step on the port's CPU path: paired reads
against several databases, with the deployment's flags
(``benchmark/configs/rrna-filter-nfcore-paired.json``).

(a) Three small databases in the manifest's order (a 5.8S-like one of
    short genes, a 16S-like and an 18S-like one) and a few hundred pairs
    from ``benchmark/reference/generate.py``; every output of the port's
    CLI held to the plain reference's judge (``reference/judge.py``).
(b) The same job on the first 1, 2 and 3 databases in small batches,
    so that most units import the read states that earlier units left:
    what a database finished stays finished, and the reports are the
    one-batch run's.  With the port's spans on, each database's pass is
    one ``align_db[<i>]`` span, every unit that imports earlier states
    one ``state_walk``, and ``db_reads_searched`` counts the reads that
    the runs on fewer databases left to search.
(c) Once a database's pass is done, its mapped index holds none of the
    job's resident memory.

The port against the JAX package on paired reads and several databases
is ``test_torch_e2e.py``'s second test.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu_torch import cli as tcli                  # noqa: E402
from sortmerna_tpu_torch import util                        # noqa: E402
from sortmerna_tpu_torch.engine.run import run_all          # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

from reference import generate, gumbel, judge  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "rrna-filter-nfcore-paired.json")
TRAFFIC = os.path.join(BENCH, "traffic", "totalrna-paired-8db.json")
SEEDS = (2 ** 31 + 4099, 7_300_000_019)
PAIRS = 160
SHORT = 16          # non-rRNA mates cut below the seed window (18)
BATCH = 128         # reads a unit: three units a database


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """The three databases and their files, the cell's flags, the
    reference's Gumbel law of each, an index directory, and the CLI
    runs made so far (``_plain``)."""
    top = tmp_path_factory.mktemp("multidb_paired")
    conf = _load(CONFIG)
    # 5.8S, arc-16S, euk-18S: the manifest's order, tens of members, of
    # one (uniform) composition, so that one Gumbel estimate serves all
    specs = [dict(conf["database"][k], n_seqs=n, n_families=f, gc=None)
             for k, n, f in ((0, 40, 4), (2, 24, 3), (6, 24, 3))]
    dbs = generate.make_databases(specs)
    paths = []
    for spec, db in zip(specs, dbs):
        paths.append(str(top / (spec["name"] + ".fasta")))
        generate.write_fasta(db, paths[-1])
    flags = [f if f != "8" else "2" for f in conf["flags"]] \
        + conf["report_flags"]
    # a 1,500-pair Gumbel estimate (the cell's is 131,072 a database):
    # good to a few percent in lambda and some tens of percent in K
    ref = gumbel.estimate(np.full(4, 0.25), conf["scoring"], 1500, 300, 1)
    idx = top / "idx"
    idx.mkdir()
    open(idx / ".keep", "w").close()      # used as given, not redirected
    return dict(top=top, conf=conf, dbs=dbs, flags=flags, idx=str(idx),
                names=[d["name"] for d in specs], paths=paths,
                refs=[ref] * len(dbs), plain={}, batched={})


def _job(dep, seed):
    """The job of ``seed``: its two gzipped FASTQ files and rRNA record.
    Mate 1 of every tenth non-rRNA pair is cut to ``SHORT`` nt, so that
    some reads are too short to be searched."""
    traffic = _load(TRAFFIC)
    del traffic["rrna_mix"]               # the three databases by nt
    got = generate.make_pairs(dep["dbs"], dep["names"], traffic, seed, 0,
                              PAIRS)
    for i in np.flatnonzero(~got.is_rrna)[::10]:
        got.mates[0].seqs[i] = got.mates[0].seqs[i][:SHORT]
    files = []
    for m, mate in enumerate(got.mates, 1):
        files.append(str(dep["top"] / f"s{seed}_{m}.fq.gz"))
        generate.write_job(files[-1],
                           generate.fastq_bytes(mate, seed, 0, m))
    return files, got.is_rrna


def _argv(dep, files, n_dbs, wd):
    return ([a for p in dep["paths"][:n_dbs] for a in ("-ref", p)]
            + [a for f in files for a in ("-reads", f)] + dep["flags"]
            + ["-idx-dir", dep["idx"], "-workdir", wd])


def _plain(dep, seed):
    """The job of ``seed`` run once by the CLI as the cell runs it:
    (its files, rRNA record, output directory)."""
    if seed not in dep["plain"]:
        files, is_rrna = _job(dep, seed)
        wd = str(dep["top"] / f"wd{seed}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SMR_TORCH_DEVICE", "cpu")
            mp.setenv("SMR_TPU_LOG", "0")
            assert tcli.main(_argv(dep, files, 3, wd)) == 0
        dep["plain"][seed] = (files, is_rrna, os.path.join(wd, "out"))
    return dep["plain"][seed]


def _batched(dep, n_dbs):
    """The job of the first seed on the first ``n_dbs`` databases in
    batches of ``BATCH`` reads, with the port's spans on: (its context,
    workdir, the spans' ``TIMERS``)."""
    if n_dbs not in dep["batched"]:
        files, _, _ = _plain(dep, SEEDS[0])
        wd = str(dep["top"] / f"batches{n_dbs}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SMR_TORCH_DEVICE", "cpu")
            mp.setenv("SMR_TPU_LOG", "0")
            mp.setattr(util, "_TIMERS_ON", True)
            mp.setattr(util, "TIMERS", {})
            ctx = run_all(tcli.parse_args(_argv(dep, files, n_dbs, wd)),
                          batch_size=BATCH, device="cpu")
            timers = {k: list(v) for k, v in util.TIMERS.items()}
        dep["batched"][n_dbs] = (ctx, wd, timers)
    return dep["batched"][n_dbs]


def _outputs(out):
    return {n: open(os.path.join(out, n), "rb").read()
            for n in sorted(os.listdir(out)) if n != "aligned.log"}


@pytest.mark.parametrize("seed", SEEDS)
def test_paired_job_against_three_databases_is_sound(deployment, seed):
    dep = deployment
    files, is_rrna, out = _plain(dep, seed)
    conf = dep["conf"]
    nums = judge.judge([dict(fastq=files, out=out, is_rrna=is_rrna)],
                       dep["dbs"], dep["flags"],
                       conf["scoring"], conf["evalue"], conf["edges"],
                       4096, seed, dep["refs"])
    # every read filed and every row checked: no number sees a fault
    for k in ("reads_misfiled", "log_mismatches", "blast_mismatches",
              "rrna_in_other", "window_gap_max", "bits_err_max"):
        assert nums[k] == 0, (k, nums)
    limits = _load(TRAFFIC)["limits"]
    assert nums["evalue_log_err_max"] <= limits["evalue_log_err_max"]
    # the small estimate's own error, not the cell's limits (0.02, 0.2)
    assert nums["lambda_rel_err"] <= 0.05 and nums["K_log_err"] <= 0.6
    # every rRNA mate has a row of its own, and each row was checked
    assert nums["rows_checked"] == nums["rows"] >= 2 * is_rrna.sum()


def test_later_databases_and_batches_leave_earlier_results(deployment):
    """Runs on the first 1, 2 and 3 databases in batches of ``BATCH``
    reads (three a job), so that every unit but the first database's
    imports the read states a previous unit left: a read done after k
    databases stays done after k + 1, and the batches leave the reports
    as the CLI's one-batch run gave them."""
    dep = deployment
    _, _, plain_out = _plain(dep, SEEDS[0])
    runs = [_batched(dep, n) for n in (1, 2, 3)]
    assert min(len(r) for r in runs[0][0].reads) == SHORT
    done = [np.array([st.is_done for st in ctx.states], bool)
            for ctx, _, _ in runs]
    for k in range(2):
        assert not (done[k] & ~done[k + 1]).any(), k
    # each later database finishes reads the earlier ones left
    assert done[0].sum() < done[1].sum() < done[2].sum()
    assert _outputs(os.path.join(runs[-1][1], "out")) == \
        _outputs(plain_out)


def test_spans_and_count_of_the_database_passes(deployment):
    """The three-database run's spans: one ``align_db[<i>]`` a database
    (each has one part), one ``state_walk`` a unit outside the first
    database's, and ``db_reads_searched`` equal to a count made from
    the read states alone: database k searches the reads of at least
    its seed window that the run on the first k databases left not
    done (every read for the first)."""
    dep = deployment
    ctx, _, timers = _batched(dep, 3)
    units = [len(range(0, len(ctx.reads), BATCH)) * len(built.parts)
             for built in ctx.indexes]
    assert [len(built.parts) for built in ctx.indexes] == [1, 1, 1]
    for i in range(3):
        assert timers[f"align_db[{i}]"][1] == 1, i
    assert "align_db[3]" not in timers
    assert timers["state_walk"][1] == sum(units) - units[0] == 6
    lens = np.array([len(r) for r in ctx.reads])
    want = 0
    for k in range(3):
        left = np.ones(len(lens), bool) if k == 0 else np.array(
            [not st.is_done for st in _batched(dep, k)[0].states])
        want += int((left & (lens >= ctx.refstats.lnwin[k])).sum())
    assert timers["db_reads_searched"] == [0.0, want]
    # the short mates are searched by no database; the rest by 1 to 3
    searchable = int((lens >= ctx.refstats.lnwin[0]).sum())
    assert searchable < len(lens) and searchable < want < 3 * searchable


def _mapped_rss_kib(top):
    """Resident KiB of each of the process's mappings of a file under
    ``top`` (``/proc/self/smaps``), by mapping."""
    got, path = {}, None
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()
            if "-" in head[0] and len(head) >= 5:        # a mapping
                path = head[0] + " " + head[-1] if len(head) >= 6 \
                    and head[-1].startswith(top) else None
            elif path and head[0] == "Rss:":
                got[path] = int(head[1])
    return got


def test_a_database_leaves_memory_after_its_pass(deployment):
    """After a job on three databases, while its context still maps
    their indexes, none of their pages is resident: each part's pass
    released its pages (``index.artifact.release_pages``), so the job
    holds the part it searches, not every part searched before.  A read
    of one array brings its pages back: the mapping still works."""
    dep = deployment
    ctx, _, _ = _batched(dep, 3)
    rss = _mapped_rss_kib(dep["idx"])
    assert len(rss) >= 3 * len(ctx.indexes[0].parts)
    assert sum(rss.values()) == 0, rss
    part = ctx.indexes[2].parts[0]
    assert int(np.asarray(part.pos_offsets)[-1]) == len(part.pos_seq)
    assert sum(_mapped_rss_kib(dep["idx"]).values()) > 0
