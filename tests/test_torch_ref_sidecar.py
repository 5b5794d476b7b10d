"""The references sidecar of an index part (``index.artifact.part_refs``).

Each index part's reference sequences, in the alignment encoding, lie
beside the part in the index directory as ``<key>.refs<i>/`` (``seq.npy``,
``off.npy``, ``headers.txt``): the first job that reads them parses the
FASTA and writes them, every later job maps them.

(a) The sidecar holds what ``load_part_refs`` parses, member by member,
    headers included: every part of a multi-part database, and each
    database of a paired three-database deployment.
(b) A first job on an empty index directory parses and writes; a second
    job parses nothing and maps every acquisition.
(c) A job's reports are byte-identical whether it maps the sidecar, runs
    without ``-idx-dir``, runs on an index directory the JAX package
    wrote (which gains its sidecar on that job), or keeps its parse in
    memory where the index directory cannot take the sidecar.
(d) A leftover temporary directory, or a sidecar missing a file, is
    ignored, and the sidecar is made anew.
"""

import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu.index import artifact as jart             # noqa: E402
from sortmerna_tpu.index import builder as jbuilder          # noqa: E402
from sortmerna_tpu_torch import cli as tcli                  # noqa: E402
from sortmerna_tpu_torch import testing, util                # noqa: E402
from sortmerna_tpu_torch.engine.align import load_part_refs  # noqa: E402
from sortmerna_tpu_torch.index import artifact as tart       # noqa: E402
from sortmerna_tpu_torch.index import builder as tbuilder    # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

from reference import generate  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "rrna-filter-nfcore-paired.json")
TRAFFIC = os.path.join(BENCH, "traffic", "totalrna-paired-8db.json")
SEED = 2 ** 31 + 77
PAIRS = 120
MB = "0.03"        # -m: splits each database into several index parts


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """Three small databases of the paired deployment (5.8S-, 16S- and
    18S-like, in the manifest's order), a paired job, and the cell's
    flags with SAM added."""
    top = tmp_path_factory.mktemp("ref_sidecar")
    conf = _load(CONFIG)
    specs = [dict(conf["database"][k], n_seqs=n, n_families=f, gc=None)
             for k, n, f in ((0, 40, 4), (2, 24, 3), (6, 24, 3))]
    dbs = generate.make_databases(specs)
    paths = []
    for spec, db in zip(specs, dbs):
        paths.append(str(top / (spec["name"] + ".fasta")))
        generate.write_fasta(db, paths[-1])
    traffic = _load(TRAFFIC)
    del traffic["rrna_mix"]               # the three databases by nt
    got = generate.make_pairs(dbs, [s["name"] for s in specs], traffic,
                              SEED, 0, PAIRS)
    files = []
    for m, mate in enumerate(got.mates, 1):
        files.append(str(top / f"r_{m}.fq.gz"))
        generate.write_job(files[-1], generate.fastq_bytes(mate, SEED, 0, m))
    flags = [f if f != "8" else "2" for f in conf["flags"]] \
        + conf["report_flags"] + ["-sam", "-m", MB]
    return SimpleNamespace(top=top, paths=paths, files=files, flags=flags)


def _argv(dep, wd, idx=None):
    return ([a for p in dep.paths for a in ("-ref", p)]
            + [a for f in dep.files for a in ("-reads", f)] + dep.flags
            + (["-idx-dir", idx] if idx else []) + ["-workdir", wd])


def _job(dep, name, idx=None):
    """One CLI job into workdir ``name`` with spans on: (its reports,
    the spans' ``TIMERS``)."""
    wd = str(dep.top / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMR_TORCH_DEVICE", "cpu")
        mp.setenv("SMR_TPU_LOG", "0")
        mp.setattr(util, "_TIMERS_ON", True)
        mp.setattr(util, "TIMERS", {})
        assert tcli.main(_argv(dep, wd, idx)) == 0
        timers = {k: list(v) for k, v in util.TIMERS.items()}
    return testing.read_reports(os.path.join(wd, "out"), [wd]), timers


def _opts(paths, idx, mb):
    return SimpleNamespace(ref_files=list(paths), idx_dir=idx, interval=1,
                           max_pos=10000, max_file_size=mb, seed_win_len=18)


def _refs_dirs(idx):
    return sorted(n for n in os.listdir(idx) if ".refs" in n)


def _assert_equals_parse(refs, path, part):
    seqs, headers = load_part_refs(path, part.first_seq, part.numseq_part,
                                   start_byte=part.start_part)
    assert len(refs) == len(seqs) == part.numseq_part
    for i, s in enumerate(seqs):
        assert refs[i].dtype == s.dtype == np.uint8
        assert np.array_equal(refs[i], s), i
    assert refs.headers == headers
    assert int(np.diff(refs.off).max()) == max(map(len, seqs))


@pytest.mark.parametrize("which", ["multipart", "paired_dbs"])
def test_sidecar_equals_the_parse(deployment, tmp_path, monkeypatch, which):
    if which == "multipart":
        db = str(tmp_path / "db.fasta")
        testing.make_db(db, 60, n_families=6, len_range=(900, 1500),
                        seed=21)
        paths, mb = [db], 0.03
    else:
        paths, mb = deployment.paths, 3072.0
    idx = str(tmp_path / "idx")
    os.makedirs(idx)
    opts = _opts(paths, idx, mb)
    monkeypatch.setattr(util, "_TIMERS_ON", True)
    monkeypatch.setattr(util, "TIMERS", {})
    n_parts = 0
    for k, path in enumerate(paths):
        built = tbuilder.build_index(path, max_file_size_mb=mb)
        if which == "multipart":
            assert len(built.parts) >= 3
        for p, part in enumerate(built.parts):
            held = {}
            first = tart.part_refs(opts, built, k, p, held)   # parsed
            assert held == {(k, p): first}
            assert tart.part_refs(opts, built, k, p, held) is first
            again = tart.part_refs(opts, built, k, p, {})     # mapped
            # and with no index directory, held in memory
            plain = tart.part_refs(_opts(paths, "", mb), built, k, p, {})
            assert first.mapped and again.mapped and not plain.mapped
            assert not again.data.flags.writeable
            for refs in (first, again, plain):
                _assert_equals_parse(refs, path, part)
            again.release()
            _assert_equals_parse(again, path, part)
        n_parts += len(built.parts)
    # the first call and the plain one parsed; the held and the fresh
    # call mapped
    assert util.TIMERS["ref_parsed"][1] == 2 * n_parts
    assert util.TIMERS["ref_mapped"][1] == 2 * n_parts
    assert len(_refs_dirs(idx)) == n_parts
    for name in _refs_dirs(idx):
        assert sorted(os.listdir(os.path.join(idx, name))) == \
            ["headers.txt", "off.npy", "seq.npy"]


def test_second_job_maps_every_acquisition(deployment):
    """(b), and the first leg of (c): a warm index directory gives the
    reports of the job that filled it."""
    dep = deployment
    idx = str(dep.top / "idx_b")
    os.makedirs(idx)
    out1, t1 = _job(dep, "wd_b1", idx)
    n_parts = len([n for n in os.listdir(idx) if ".part" in n])
    assert n_parts > len(dep.paths)                  # -m split them
    assert len(_refs_dirs(idx)) == n_parts
    # the align pass parses each part once; the report sweep maps it
    assert t1["ref_parsed"][1] == t1["ref_mapped"][1] == n_parts
    assert t1["ref_load"][1] == 2 * n_parts
    out2, t2 = _job(dep, "wd_b2", idx)
    assert "ref_parsed" not in t2
    assert t2["ref_mapped"][1] == t2["ref_load"][1] == 2 * n_parts
    assert out2 == out1
    assert {"aligned_fwd.fq", "aligned_rev.fq", "other_fwd.fq",
            "other_rev.fq", "aligned.blast", "aligned.sam",
            "aligned.log"} <= set(out1)
    assert out1["aligned.blast"] and out1["aligned.sam"]
    deployment.warm = out2


def test_reports_alike_whatever_holds_the_references(deployment,
                                                     monkeypatch):
    """(c): without -idx-dir (the workdir's own index directory), on an
    index directory the JAX package wrote, and with the parse kept in
    memory where the sidecar cannot be written."""
    dep = deployment
    if not hasattr(dep, "warm"):
        test_second_job_maps_every_acquisition(dep)
    out, _ = _job(dep, "wd_c_none")
    assert out == dep.warm
    assert len(_refs_dirs(str(dep.top / "wd_c_none" / "idx"))) > 0

    opts = tcli.parse_args(_argv(dep, str(dep.top / "wd_c_jax")))
    idx = str(dep.top / "idx_jax")
    os.makedirs(idx)
    for path in dep.paths:
        key = jart.index_key(path, opts.interval, opts.max_pos,
                             opts.max_file_size, opts.seed_win_len)
        assert key == tart.index_key(path, opts.interval, opts.max_pos,
                                     opts.max_file_size, opts.seed_win_len)
        jart.save_index(jbuilder.build_index(
            path, opts.interval, opts.max_pos, opts.max_file_size,
            seed_win_len=opts.seed_win_len), idx, key)
    assert _refs_dirs(idx) == []
    out, t = _job(dep, "wd_c_jax", idx)
    assert out == dep.warm
    n_parts = len([n for n in os.listdir(idx) if ".part" in n])
    assert len(_refs_dirs(idx)) == n_parts == t["ref_parsed"][1]

    # an index directory that cannot take the sidecar: each part is
    # parsed once and held for the job's report sweep
    idx = str(dep.top / "idx_ro")
    os.makedirs(idx)
    monkeypatch.setattr(tart, "_write_refs", lambda rdir, refs: False)
    out, t = _job(dep, "wd_c_ro", idx)
    assert out == dep.warm
    assert _refs_dirs(idx) == [] and "ref_mapped" not in t
    assert t["ref_parsed"][1] == t["ref_load"][1] == 2 * n_parts


def test_broken_sidecar_is_made_anew(deployment, tmp_path, monkeypatch):
    """(d): a leftover temporary directory of a writer that died, and a
    sidecar that lost a file, are both passed over: the part is parsed
    and its sidecar written whole."""
    db = str(tmp_path / "db.fasta")
    testing.make_db(db, 60, n_families=4, len_range=(900, 1500), seed=23)
    idx = str(tmp_path / "idx")
    os.makedirs(idx)
    opts = _opts([db], idx, 0.03)
    built = tbuilder.build_index(db, max_file_size_mb=0.03)
    assert len(built.parts) >= 3
    for p in range(len(built.parts)):
        tart.part_refs(opts, built, 0, p, {})
    key = tart.index_key(db, 1, 10000, 0.03, 18)
    # part 0: a sidecar without its headers; part 1: gone, with a dead
    # writer's half-written directory (and one of this pid) beside it
    os.remove(os.path.join(idx, f"{key}.refs0", "headers.txt"))
    shutil.rmtree(os.path.join(idx, f"{key}.refs1"))
    for pid in (999999, os.getpid()):
        tmp = os.path.join(idx, f"{key}.refs1.tmp.{pid}")
        os.makedirs(tmp)
        np.save(os.path.join(tmp, "seq.npy"), np.zeros(3, np.uint8))
    # part 2: a truncated offsets file
    off_p = os.path.join(idx, f"{key}.refs2", "off.npy")
    with open(off_p, "r+b") as f:
        f.truncate(os.path.getsize(off_p) - 8)
    monkeypatch.setattr(util, "_TIMERS_ON", True)
    for p in range(3):
        monkeypatch.setattr(util, "TIMERS", {})
        tart.part_refs(opts, built, 0, p, {})
        assert util.TIMERS == {"ref_parsed": [0.0, 1]}, p   # and written
        again = tart.part_refs(opts, built, 0, p, {})
        assert again.mapped and util.TIMERS["ref_mapped"] == [0.0, 1], p
        _assert_equals_parse(again, db, built.parts[p])
    assert not os.path.exists(os.path.join(idx, f"{key}.refs1.tmp."
                                           f"{os.getpid()}"))
