"""The align task end to end: the port's CLI against the JAX package's.

Both CLIs run the same seeded synthetic workload into their own workdirs
(the port on ``SMR_TORCH_DEVICE=cpu``, i.e. the kernels' plain PyTorch
versions); every report must be byte-identical -- aligned.sam without its
@PG line and aligned.log without its command, pid and date lines.

(a) the verify recipe's flags on a 200-sequence DB with 2,000 reads; the
    two CLIs share one index directory (the JAX package writes it, the
    port reads it);
(b) paired reads against two DBs, each split into >= 2 index parts by
    -m, with >= 8192 reads cut into 4 slices (the port's
    OVERLAP_SLICES), so the overlap scheduler drives the SW waves (the
    test counts its runs); each CLI builds its own index and Gumbel
    statistics.
"""

import os

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402

REPORTS = ("aligned.blast", "aligned.fa", "other.fa", "otu_map.txt",
           "aligned_denovo.fa", "aligned.sam", "aligned.log")


def _run_both(monkeypatch, top, argv_of, shared_idx):
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    idx = {"jax": str(top / "idx"), "torch": str(top / "idx")} \
        if shared_idx else {"jax": str(top / "idx_jax"),
                            "torch": str(top / "idx_torch")}
    for d in set(idx.values()):
        # a non-empty idx dir is used as given (the suite's conftest
        # redirects empty ones to its shared cache)
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, ".keep"), "w").close()
    assert jcli.main(argv_of(idx["jax"], str(top / "wd_jax"))) == 0
    assert tcli.main(argv_of(idx["torch"], str(top / "wd_torch"))) == 0
    got = {k: testing.read_outputs(str(top / f"wd_{k}" / "out"),
                                   [str(top / f"wd_{k}")])
           for k in ("jax", "torch")}
    assert set(got["jax"]) == set(REPORTS)
    for name in REPORTS:
        assert got["torch"][name] == got["jax"][name], name
    return got["torch"]


def test_e2e_verify_flags_match_jax(tmp_path, monkeypatch):
    db = str(tmp_path / "db.fasta")
    reads = str(tmp_path / "reads.fasta")
    seqs = testing.make_db(db, 200, n_families=20, len_range=(1400, 1500),
                           seed=11)
    testing.make_reads(reads, seqs, 2000, seed=12)

    def argv(idx, wd):
        return ["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS + \
            ["-idx-dir", idx, "-workdir", wd]

    out = _run_both(monkeypatch, tmp_path, argv, shared_idx=True)
    n_aligned = out["aligned.fa"].count(b">")
    assert 500 < n_aligned < 2000
    assert out["aligned.blast"] and out["otu_map.txt"]


def test_e2e_paired_two_db_multipart_grouped_match_jax(tmp_path,
                                                       monkeypatch):
    from sortmerna_tpu_torch.engine import align
    db1 = str(tmp_path / "db1.fasta")
    db2 = str(tmp_path / "db2.fasta")
    s1 = testing.make_db(db1, 40, n_families=5, len_range=(1300, 1500),
                         seed=31, name="a")
    s2 = testing.make_db(db2, 24, n_families=6, len_range=(1100, 1300),
                         divergence=0.18, seed=32, name="b")
    r1, r2 = str(tmp_path / "r_1.fasta"), str(tmp_path / "r_2.fasta")
    n_pairs = 4200
    testing.make_paired_reads(r1, r2, s1 + s2, n_pairs, seed=33)
    monkeypatch.setitem(align.OVERLAP_SLICES, "cpu", 4)
    # the overlap scheduler takes batches of at least OVERLAP_MIN_READS
    # reads; count the port's parts that went through it
    assert 2 * n_pairs >= align.OVERLAP_MIN_READS
    grouped = []
    orig = align._run_part_overlapped

    def spy(*a, **kw):
        grouped.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(align, "_run_part_overlapped", spy)

    def argv(idx, wd):
        return ["-ref", db1, "-ref", db2, "-reads", r1, "-reads", r2,
                "-fastx", "-other", "-paired_in", "-sam",
                "-blast", "1 cigar qcov qstrand", "-otu_map",
                "-de_novo_otu", "-m", "0.2", "-idx-dir", idx,
                "-workdir", wd]

    out = _run_both(monkeypatch, tmp_path, argv, shared_idx=False)
    # -m 0.2 splits the DBs into 3 and 2 index parts, each one grouped run
    assert len(grouped) == 5
    assert out["aligned_denovo.fa"] and out["otu_map.txt"]
    sam = out["aligned.sam"].decode()
    assert any(f"\ta{i}_" in sam for i in range(5))
    assert any(f"\tb{i}_" in sam for i in range(6))
