"""The port's host layers against the JAX package's, array for array.

The feed, the dense index (fresh builds, the reference-format golden
artifacts, an index directory written by the JAX package) and the
reference statistics must come out equal in both packages on the same
seeded synthetic inputs.
"""

import dataclasses
import gzip
import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import sortmerna_tpu.index.artifact as jart                  # noqa: E402
import sortmerna_tpu_torch.index.artifact as tart            # noqa: E402
from sortmerna_tpu import native as jnative                  # noqa: E402
from sortmerna_tpu.index import builder as jbuilder          # noqa: E402
from sortmerna_tpu.index import refformat as jref            # noqa: E402
from sortmerna_tpu.io import feed as jfeed                   # noqa: E402
from sortmerna_tpu.stats import refstats as jstats           # noqa: E402
from sortmerna_tpu_torch import native as tnative            # noqa: E402
from sortmerna_tpu_torch import testing                      # noqa: E402
from sortmerna_tpu_torch.index import builder as tbuilder    # noqa: E402
from sortmerna_tpu_torch.index import refformat as tref      # noqa: E402
from sortmerna_tpu_torch.io import feed as tfeed             # noqa: E402
from sortmerna_tpu_torch.stats import refstats as tstats     # noqa: E402

GOLDEN_REFIDX = pathlib.Path(__file__).parent / "golden" / "refidx"
PART_ARRAYS = [f.name for f in dataclasses.fields(tbuilder.IndexPart)]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    top = tmp_path_factory.mktemp("torch_host")
    db = str(top / "db.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1500),
                           seed=21)
    reads = str(top / "reads.fasta")
    testing.make_reads(reads, seqs, 400, seed=22)
    r1, r2 = str(top / "r1.fasta"), str(top / "r2.fasta")
    testing.make_paired_reads(r1, r2, seqs, 150, seed=23)
    fq = str(top / "reads.fastq")
    with open(reads) as f, open(fq, "w") as g:
        lines = f.read().split("\n")
        for h, s in zip(lines[0::2], lines[1::2]):
            if h:
                g.write(f"@{h[1:]}\n{s}\n+\n{'I' * len(s)}\n")
    return dict(top=top, db=db, reads=reads, paired=(r1, r2), fastq=fq)


def _assert_part_equal(a, b):
    for name in PART_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, name
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
        else:
            assert x == y, name


def _assert_index_equal(a, b):
    for f in ("fasta_size", "full_len", "seed_win_len", "numseq"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    assert np.array_equal(a.stats.background_freq, b.stats.background_freq)
    assert [(m.header, m.length) for m in a.stats.sam_sq] == \
        [(m.header, m.length) for m in b.stats.sam_sq]
    assert len(a.parts) == len(b.parts)
    for pa, pb in zip(a.parts, b.parts):
        _assert_part_equal(pa, pb)


@pytest.mark.parametrize("which", ["fasta", "paired", "fastq"])
def test_feed_arrays_match(synth, tmp_path, which):
    files = {"fasta": [synth["reads"]], "paired": list(synth["paired"]),
             "fastq": [synth["fastq"]]}[which]
    a = jfeed.ReadFeed(files, str(tmp_path / "j"))
    b = tfeed.ReadFeed(files, str(tmp_path / "t"))
    assert (a.n, a.total_len, a.min_len, a.max_len, a.paired) == \
        (b.n, b.total_len, b.min_len, b.max_len, b.paired)
    for fa, fb in zip(a.files, b.files):
        for name in ("seq", "seq_off", "hdr", "hdr_off", "qual",
                     "qual_off"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert np.array_equal(x, y), name
    for x, y in zip(a.packed_slice(0, a.n), b.packed_slice(0, b.n)):
        assert np.array_equal(x, y)
    r = b.readseq(b.n - 1)
    assert (r.header, r.sequence) == (a.readseq(a.n - 1).header,
                                      a.readseq(a.n - 1).sequence)


@pytest.mark.parametrize("max_mb", [3072.0, 0.03])
def test_dense_index_parts_match(synth, max_mb):
    a = jbuilder.build_index(synth["db"], max_file_size_mb=max_mb)
    b = tbuilder.build_index(synth["db"], max_file_size_mb=max_mb)
    if max_mb < 1:
        assert len(b.parts) >= 2
    _assert_index_equal(b, a)


@pytest.mark.parametrize("prefix", ["GQ", "GQ14"])
def test_refformat_reads_golden_refidx_alike(tmp_path, prefix):
    for gz in GOLDEN_REFIDX.glob(prefix + ".*.gz"):
        (tmp_path / gz.name[:-3]).write_bytes(
            gzip.decompress(gz.read_bytes()))
    pfx = str(tmp_path / prefix)
    sa, sb = tref.read_stats(pfx + ".stats"), jref.read_stats(pfx + ".stats")
    assert sa.keys() == sb.keys()
    for k in sb:
        if k == "sam_sq":       # RefSeqMeta is each package's own class
            assert [(m.header, m.length) for m in sa[k]] == \
                [(m.header, m.length) for m in sb[k]]
        else:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    _assert_index_equal(tref.read_reference_index(pfx),
                        jref.read_reference_index(pfx))


def test_jax_written_idx_dir_loads_in_port(synth, tmp_path):
    """An index directory written by the JAX package serves the port
    unchanged, and from_numpy_parts rebuilds the same index from the JAX
    package's part arrays; both equal the port's own build."""
    own = tbuilder.build_index(synth["db"], max_file_size_mb=0.03)
    jax_built = jbuilder.build_index(synth["db"], max_file_size_mb=0.03)
    idx = str(tmp_path / "idx")
    key = jart.index_key(synth["db"], 1, 10000, 0.03)
    assert key == tart.index_key(synth["db"], 1, 10000, 0.03)
    jart.save_index(jax_built, idx, key)
    _assert_index_equal(tart.load_index(idx, key), own)
    _assert_index_equal(tart.build_or_load(
        synth["db"], idx, 1, 10000, 0.03), own)
    parts = [{f.name: getattr(p, f.name)
              for f in dataclasses.fields(p)} for p in jax_built.parts]
    stats = {f.name: getattr(jax_built.stats, f.name)
             for f in dataclasses.fields(jax_built.stats)}
    _assert_index_equal(tart.from_numpy_parts(parts, stats), own)


def test_refstats_match(synth):
    a = jbuilder.build_index(synth["db"])
    b = tbuilder.build_index(synth["db"])
    args = (400, 400 * 125, 1.0, 2, -3, 5, 2)
    ra = jstats.compute_refstats([a], *args)
    rb = tstats.compute_refstats([b], *args)
    assert rb.minimal_score == ra.minimal_score
    assert rb.lnwin == ra.lnwin
    assert rb.gumbel == ra.gumbel


def test_native_libraries_are_separate_and_coexist():
    assert tnative.have_native() and jnative.have_native()
    assert tnative._BUILD_DIR.name == "native_torch"
    a = tnative.get_lib()._name
    b = jnative.get_lib()._name
    assert os.path.basename(a) == "libsmrtorch_native.so"
    assert os.path.realpath(a) != os.path.realpath(b)
