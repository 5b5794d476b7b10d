"""The port's batch-major SW scan (v2, ``SMR_PALLAS=2``) against the JAX
package, int32-exact.

The plain PyTorch versions ``sw_scan2_plain`` and ``sw_fused2_plain`` (what
the wrappers run on CPU tensors, and what the ``csrc/sw_scan2.cu`` kernels
are held against on the card) must equal the JAX package's v2 Pallas kernel
in interpret mode (``sw_scan_pallas2``), and ``sw_fused_call`` with it
dispatched, bit for bit -- on the odd inputs where v2 differs from v1 too.
On ordinary inputs v2 equals the XLA scan, so the CLI with ``SMR_PALLAS=2``
around the port's run must write the JAX CLI's default reports.  Inputs
come from numpy.random.default_rng(seed).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.constants import scoring_matrix_5x5      # noqa: E402
from sortmerna_tpu.ops import sw_jax, sw_pallas             # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.ops import sw_kernels as K         # noqa: E402
from sortmerna_tpu_torch.ops.sw_torch import TorchSwBackend  # noqa: E402

from .test_torch_sw import _coord_jobs                      # noqa: E402

MAT = scoring_matrix_5x5(2, -3, 0).astype(np.int32)


def _tiles(rng, B, Lq, Lr):
    """Uniform tiles with prefix masks, as tests/test_sw_pallas.py makes
    them."""
    Q = rng.integers(0, 5, (B, Lq)).astype(np.int32)
    R = rng.integers(0, 5, (B, Lr)).astype(np.int32)
    qlen = rng.integers(1, Lq + 1, B)
    rlen = rng.integers(1, Lr + 1, B)
    rv = np.arange(Lq)[None, :] < qlen[:, None]
    cv = np.arange(Lr)[None, :] < rlen[:, None]
    return Q, rv, R, cv


def _jax(fn, Q, rv, R, cv, terminate, ts, gaps=(5, 2), **kw):
    out = fn(jnp.asarray(Q), jnp.asarray(rv), jnp.asarray(R),
             jnp.asarray(cv), jnp.asarray(MAT), *gaps, terminate,
             None if ts is None else jnp.asarray(ts), **kw)
    return [np.asarray(o) for o in out]


_pallas2 = functools.partial(_jax, sw_pallas.sw_scan_pallas2, interpret=True)


def _plain2(Q, rv, R, cv, terminate, ts, gaps=(5, 2)):
    t = torch.from_numpy
    out = K.sw_scan2_plain(t(Q), t(rv), t(R), t(cv), t(MAT), *gaps,
                           terminate, None if ts is None else t(ts))
    return [o.numpy() for o in out]


def _assert_same(got, want):
    for name, g, w in zip(("best", "end_ref", "end_read"), got, want):
        assert g.dtype == np.int32, name
        assert np.array_equal(g, w), name


def _forward_best(Q, rv, R, cv):
    return _jax(sw_jax._sw_scan, Q, rv, R, cv, False, None)[0].copy()


@pytest.mark.parametrize("terminate", [False, True])
def test_scan2_plain_matches_pallas2(terminate):
    Q, rv, R, cv = _tiles(np.random.default_rng(7 + terminate), 512, 32, 64)
    ts = _forward_best(Q, rv, R, cv) if terminate else None
    want = _pallas2(Q, rv, R, cv, terminate, ts)
    _assert_same(_plain2(Q, rv, R, cv, terminate, ts), want)
    assert (want[1] >= 0).any() and (want[0] > 0).any()


@pytest.mark.parametrize("terminate", [False, True])
def test_scan2_plain_matches_pallas2_on_odd_inputs(terminate):
    """Where v2 differs from v1: ref chars outside 0..4 in valid columns
    (negative reads as 0, 5 and above make the column invalid), query
    chars above 4 (profile 4), ragged masks, and a tile of 136 columns
    whose last 128-column chunk is read from column 8 on."""
    B, Lq, Lr = 512, 8, 136
    rng = np.random.default_rng(21 + terminate)
    Q, rv, R, cv = _tiles(rng, B, Lq, Lr)
    Q[rng.random((B, Lq)) < 0.1] = 6
    odd = rng.random((B, Lr)) < 0.15
    R[odd] = rng.choice([-3, -1, 5, 6, 7, 9], int(odd.sum()))
    R[::3, 128:] = Q[::3, :8]           # matches in the clamped chunk
    rv = rv & (rng.random((B, Lq)) < 0.9)
    ts = _forward_best(Q, rv, R, cv) if terminate else None
    want = _pallas2(Q, rv, R, cv, terminate, ts)
    _assert_same(_plain2(Q, rv, R, cv, terminate, ts), want)
    # the odd chars do change the result: v1's function differs here
    t = torch.from_numpy
    v1 = K.sw_scan_plain(t(Q), t(rv), t(R), t(cv), t(MAT), 5, 2, terminate,
                         None if ts is None else t(ts))
    assert not all(np.array_equal(a.numpy(), b) for a, b in zip(v1, want))


@pytest.mark.parametrize("terminate", [False, True])
def test_scan2_plain_matches_pallas2_on_odd_codes(terminate):
    """Query and ref chars in -7..15: a query char reads the profile row
    of mat.T[Q] (negative codes wrap once, then clamp: -1 reads profile
    4), a ref char v2's read (negative as 0, 5 and above invalid)."""
    rng = np.random.default_rng(31 + terminate)
    Q, rv, R, cv, _, _ = testing.odd_tiles(rng, 512, 12, 24)
    ts = _forward_best(Q, rv, R, cv) if terminate else None
    want = _pallas2(Q, rv, R, cv, terminate, ts)
    _assert_same(_plain2(Q, rv, R, cv, terminate, ts), want)
    # the odd query codes matter: clamped to 0..4 they give another result
    got = _plain2(np.clip(Q, 0, 4), rv, R, cv, terminate, ts)
    assert not all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("terminate", [False, True])
def test_scan2_plain_wide_tile_three_reduction_tiebreak(terminate):
    """Lq = 4096 is past the packed-key limit ((Lq << s) >= 2**24), so v2
    takes its 3-reduction tie-break; held against the XLA scan (the
    interpreter is too slow at this width)."""
    B, Lq, Lr = 512, 4096, 12
    s = max((Lq - 1).bit_length(), 1)
    assert (Lq << s) >= 1 << 24
    rng = np.random.default_rng(40 + terminate)
    Q, rv, R, cv, _, _ = testing.scan_tiles(rng, B, Lq, Lr)
    Q[256:] = 0                 # tie-heavy rows: many equal column maxima
    R[256:] = 0
    ts = _forward_best(Q, rv, R, cv) if terminate else None
    _assert_same(_plain2(Q, rv, R, cv, terminate, ts),
                 _jax(sw_jax._sw_scan, Q, rv, R, cv, terminate, ts))


@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_scan2_plain_matches_pallas2_on_edge_inputs(gaps, terminate):
    """testing.edge_tiles: query lengths 1..Lq in one block, tie-heavy
    pairs, holes in the row mask; gap penalties with go < ge and zero;
    in terminate mode a tscore below the forward best, so scans stop
    mid-tile.  The same inputs hold the CUDA kernel on the card."""
    go, ge = gaps
    rng = np.random.default_rng(100 + 10 * go + ge + terminate)
    Q, rv, R, cv = testing.edge_tiles(rng, 512, 72, 80)
    fw_best = _plain2(Q, rv, R, cv, False, None, gaps)[0]
    ts = testing.edge_tscore(rng, fw_best) if terminate else None
    want = _pallas2(Q, rv, R, cv, terminate, ts, gaps)
    _assert_same(_plain2(Q, rv, R, cv, terminate, ts, gaps), want)
    assert (want[1] >= 0).sum() > 400
    if terminate:               # some scans stopped before their best
        assert (want[0] < fw_best).sum() > 20


@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_fused2_plain_matches_pallas2_on_edge_blocks(gaps, monkeypatch):
    """testing.edge_block (read lengths 1..lq in one block, tie-heavy
    pairs, most pairs through the begin pass) through sw_fused_call with
    SMR_PALLAS=2 and the v2 kernel interpreted, unjitted (so no trace of
    another test is reused), at each edge gap pair."""
    go, ge = gaps
    B, lq, lr = 512, 48, 64
    buf = testing.edge_block(np.random.default_rng(200 + 10 * go + ge),
                             B, lq, lr)
    monkeypatch.setenv("SMR_PALLAS", "2")
    traced = []
    orig = sw_pallas.sw_scan_pallas2

    def pallas2(*a, **kw):
        traced.append(1)
        return orig(*a, interpret=True, **kw)

    monkeypatch.setattr(sw_pallas, "sw_scan_pallas2", pallas2)
    want = np.asarray(sw_jax.sw_fused_call.__wrapped__(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, go, ge))
    assert len(traced) == 2             # both passes took the v2 kernel
    got = K.sw_fused2_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                            B, lq, lr, go, ge).numpy()
    assert np.array_equal(got, want)
    assert (want[1] >= 0).sum() > 150


def test_scan2_rejects_a_batch_off_the_512_grid():
    Q, rv, R, cv = (torch.from_numpy(a) for a in
                    _tiles(np.random.default_rng(3), 300, 16, 16))
    mat = torch.from_numpy(MAT)
    for fn in (K.sw_scan2_plain, K.sw_scan2):
        with pytest.raises(ValueError, match="multiple of 512"):
            fn(Q, rv, R, cv, mat, 5, 2, False, None)


@pytest.mark.parametrize("shape", [(64, 256, 256), (300, 256, 256),
                                   (48, 512, 256)])
def test_fused2_plain_matches_sw_fused_call(shape):
    """Any B, ragged included (the JAX v2 path would raise there): on the
    wave blocks' inputs v2 is the XLA scan's function."""
    B, lq, lr = shape
    buf = testing.fused_block(np.random.default_rng(sum(shape)), B, lq, lr)
    want = np.asarray(sw_jax.sw_fused_call(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, 5, 2))
    got = K.sw_fused2_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                            B, lq, lr, 5, 2).numpy()
    assert got.dtype == np.int32 and got.shape == (5, B)
    assert np.array_equal(got, want)
    assert want[2, 2] == -1 and want[1, 3] == -1 and (want[1] >= 0).any()


def test_fused2_plain_matches_sw_fused_call_with_pallas2(monkeypatch):
    """sw_fused_call with SMR_PALLAS=2 and the v2 kernel interpreted, on a
    block with nibbles 5..15 in the windows and a 136-column ref tile."""
    B, lq, lr = 512, 16, 136
    rng = np.random.default_rng(77)
    buf = testing.fused_block(rng, B, lq, lr)
    odd = rng.random((B, lq // 2 + lr // 2)) < 0.03
    buf[:, :lq // 2 + lr // 2][odd] = rng.integers(0x50, 0x100,
                                                   int(odd.sum()))
    buf[:, -4:] = np.array([12], "<i4").view(np.uint8)     # minimal 12
    monkeypatch.setenv("SMR_PALLAS", "2")
    traced = []
    orig = sw_pallas.sw_scan_pallas2

    def pallas2(*a, **kw):
        traced.append(1)
        return orig(*a, interpret=True, **kw)

    monkeypatch.setattr(sw_pallas, "sw_scan_pallas2", pallas2)
    # gap_open 6 keeps this trace out of the jit cache of other tests
    want = np.asarray(sw_jax.sw_fused_call(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, 6, 2))
    assert len(traced) == 2             # both passes took the v2 kernel
    got = K.sw_fused2_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                            B, lq, lr, 6, 2).numpy()
    assert np.array_equal(got, want)
    assert (want[1] >= 0).sum() > 100


class _Spy:
    """Counts the calls of a module function, passing them through."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        orig = getattr(module, name)

        def spy(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)

        monkeypatch.setattr(module, name, spy)


def test_backend_v2_coords_match_jax_backend(monkeypatch):
    jobs = _coord_jobs(11, 300)
    want = sw_jax.JaxSwBackend(MAT, 5, 2).batch_coords(*jobs)
    monkeypatch.setenv("SMR_PALLAS", "2")
    v2 = _Spy(monkeypatch, K, "sw_fused2_plain")
    v1 = _Spy(monkeypatch, K, "sw_fused_plain")
    got = TorchSwBackend(MAT, 5, 2, device="cpu").batch_coords(*jobs)
    for name, g, w in zip(("score", "beg_ref", "end_ref", "beg_read",
                           "end_read"), got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name
    assert v2.calls > 0 and v1.calls == 0


def test_cli_pallas2_matches_jax_cli(tmp_path, monkeypatch):
    """The port's CLI with SMR_PALLAS=2 (cpu: sw_fused2_plain) writes the
    JAX CLI's default reports byte for byte."""
    db = str(tmp_path / "db.fasta")
    reads = str(tmp_path / "reads.fasta")
    seqs = testing.make_db(db, 200, n_families=20, len_range=(1400, 1500),
                           seed=11)
    testing.make_reads(reads, seqs, 2000, seed=12)
    idx = tmp_path / "idx"
    idx.mkdir()
    (idx / ".keep").write_text("")

    def argv(wd):
        return ["-ref", db, "-reads", reads] + testing.VERIFY_FLAGS + \
            ["-idx-dir", str(idx), "-workdir", str(tmp_path / wd)]

    monkeypatch.delenv("SMR_PALLAS", raising=False)
    assert jcli.main(argv("wd_jax")) == 0
    monkeypatch.setenv("SMR_PALLAS", "2")
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    v2 = _Spy(monkeypatch, K, "sw_fused2_plain")
    v1 = _Spy(monkeypatch, K, "sw_fused_plain")
    assert tcli.main(argv("wd_torch")) == 0
    assert v2.calls > 0 and v1.calls == 0
    got = {k: testing.read_outputs(str(tmp_path / f"wd_{k}" / "out"),
                                   [str(tmp_path / f"wd_{k}")])
           for k in ("jax", "torch")}
    assert len(got["jax"]) == 7
    for name in got["jax"]:
        assert got["torch"][name] == got["jax"][name], name
    assert got["torch"]["aligned.fa"].count(b">") > 500
