"""The long-tile kernels' stripe decomposition against the JAX package.

``sw_kernels.stripe_scan_plain`` runs a pair's column scan in row stripes
of a given height, each stripe consuming the stripe above's bottom-row H,
F carry and 64-bit column key per column, with improved / terminate
applied at the last stripe only: the hand-off that the CUDA long-tile
route makes between warps and between the CTAs of a cluster, written
plainly.  It must equal the JAX package's XLA scan (``_sw_scan``),
``sw_fused_call`` and the v2 Pallas kernel in interpret mode
(``sw_scan_pallas2``) bit for bit, at stripe heights that bring out
off-by-ones (1, 7, 32, 64), in both terminate modes, at the edge gap
pairs, on the tie-heavy and row-hole edge tiles, past the packed-key
limit, and on v1's and v2's odd codes.  Inputs come from
numpy.random.default_rng(seed).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from sortmerna_tpu.constants import scoring_matrix_5x5      # noqa: E402
from sortmerna_tpu.ops import sw_jax, sw_pallas             # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.ops import sw_kernels as K         # noqa: E402

MAT = scoring_matrix_5x5(2, -3, 0).astype(np.int32)
HEIGHTS = (1, 7, 32, 64)


def _jax(fn, Q, rv, R, cv, terminate, ts, gaps, **kw):
    out = fn(jnp.asarray(Q), jnp.asarray(rv), jnp.asarray(R),
             jnp.asarray(cv), jnp.asarray(MAT), *gaps, terminate,
             None if ts is None else jnp.asarray(ts), **kw)
    return [np.asarray(o) for o in out]


_xla = functools.partial(_jax, sw_jax._sw_scan)
_pallas2 = functools.partial(_jax, sw_pallas.sw_scan_pallas2, interpret=True)


def _stripes(Q, rv, R, cv, terminate, ts, gaps, height, version=1):
    t = torch.from_numpy
    out = K.stripe_scan_plain(t(Q), t(rv), t(R), t(cv), t(MAT), *gaps,
                              terminate, None if ts is None else t(ts),
                              height, version)
    return [o.numpy() for o in out]


def _assert_same(got, want):
    for name, g, w in zip(("best", "end_ref", "end_read"), got, want):
        assert g.dtype == np.int32, name
        assert np.array_equal(g, w), name


def _terminate_at(rng, Q, rv, R, cv, gaps, terminate, scan=_xla):
    if not terminate:
        return None
    return testing.edge_tscore(rng, scan(Q, rv, R, cv, False, None, gaps)[0])


@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_stripes_match_xla_scan_on_edge_tiles(height, gaps, terminate):
    """testing.edge_tiles with v1's odd chars (query lengths 1..Lq, holes
    in the row mask, tie-heavy pairs, codes in -7..15) against _sw_scan,
    in terminate mode at a tscore below the forward best."""
    rng = np.random.default_rng(500 + height + 10 * gaps[0] + gaps[1]
                                + terminate)
    Q, rv, R, cv = testing.edge_tiles(rng, 48, 72, 40, odd=True)
    ts = _terminate_at(rng, Q, rv, R, cv, gaps, terminate)
    want = _xla(Q, rv, R, cv, terminate, ts, gaps)
    _assert_same(_stripes(Q, rv, R, cv, terminate, ts, gaps, height), want)
    assert (want[1] >= 0).sum() > 20


@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("terminate", [False, True])
def test_stripes_match_pallas2_on_edge_tiles(height, terminate):
    """v2's column reads (the 128-column chunk clamp at Lr = 136, chars
    5..15 invalid, NEG = -(1 << 29)) against the v2 Pallas kernel in
    interpret mode, on edge tiles with odd codes."""
    gaps = (5, 2)
    rng = np.random.default_rng(600 + height + terminate)
    Q, rv, R, cv = testing.edge_tiles(rng, 512, 24, 136, odd=True)
    ts = _terminate_at(rng, Q, rv, R, cv, gaps, terminate, _pallas2)
    want = _pallas2(Q, rv, R, cv, terminate, ts, gaps)
    _assert_same(_stripes(Q, rv, R, cv, terminate, ts, gaps, height, 2),
                 want)
    assert (want[1] >= 0).sum() > 200


@pytest.mark.parametrize("gaps", [(1, 3), (0, 0)])
def test_stripes_match_pallas2_at_edge_gaps(gaps):
    """v2 at the other edge gap pairs, in terminate mode, stripes of 7."""
    rng = np.random.default_rng(650 + 10 * gaps[0] + gaps[1])
    Q, rv, R, cv = testing.edge_tiles(rng, 512, 24, 40, odd=True)
    ts = _terminate_at(rng, Q, rv, R, cv, gaps, True, _pallas2)
    _assert_same(_stripes(Q, rv, R, cv, True, ts, gaps, 7, 2),
                 _pallas2(Q, rv, R, cv, True, ts, gaps))


@pytest.mark.parametrize("height", [32, 64])
@pytest.mark.parametrize("terminate", [False, True])
def test_stripes_wide_tile_past_the_packed_key(height, terminate):
    """Lq = 4096 is past the packed-key limit ((Lq << s) >= 2**24): the JAX
    scan takes its 3-reduction tie-break, which the 64-bit key gives too;
    tie-heavy rows make many equal column maxima."""
    B, Lq, Lr = 6, 4096, 24
    s = max((Lq - 1).bit_length(), 1)
    assert (Lq << s) >= 1 << 24
    rng = np.random.default_rng(700 + height + terminate)
    Q, rv, R, cv, _, _ = testing.scan_tiles(rng, B, Lq, Lr)
    Q[3:] = 0
    R[3:] = 0
    gaps = (5, 2)
    ts = _xla(Q, rv, R, cv, False, None, gaps)[0].copy() if terminate \
        else None
    _assert_same(_stripes(Q, rv, R, cv, terminate, ts, gaps, height),
                 _xla(Q, rv, R, cv, terminate, ts, gaps))


@pytest.mark.parametrize("height", [7, 32])
@pytest.mark.parametrize("terminate", [False, True])
def test_stripes_match_on_odd_codes(height, terminate):
    """Query and ref codes in -7..15 (testing.odd_tiles): v1's reads
    against _sw_scan, v2's against the v2 Pallas kernel."""
    gaps = (5, 2)
    rng = np.random.default_rng(800 + height + terminate)
    Q, rv, R, cv, _, _ = testing.odd_tiles(rng, 512, 20, 24)
    ts = _xla(Q, rv, R, cv, False, None, gaps)[0].copy() if terminate \
        else None
    _assert_same(_stripes(Q, rv, R, cv, terminate, ts, gaps, height),
                 _xla(Q, rv, R, cv, terminate, ts, gaps))
    _assert_same(_stripes(Q, rv, R, cv, terminate, ts, gaps, height, 2),
                 _pallas2(Q, rv, R, cv, terminate, ts, gaps))


@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_stripes_fused_match_sw_fused_call(height, gaps):
    """Both passes of sw_fused_call in stripes (the begin pass on the
    flipped tile, in terminate mode at the forward score), on
    testing.edge_block with v1's odd nibbles."""
    go, ge = gaps
    B, lq, lr = 32, 48, 64
    buf = testing.edge_block(np.random.default_rng(900 + height + 10 * go
                                                   + ge), B, lq, lr,
                             odd=True)
    want = np.asarray(sw_jax.sw_fused_call(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, go, ge))
    got = K.stripe_fused_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                               B, lq, lr, go, ge, height).numpy()
    assert np.array_equal(got, want)
    assert (want[1] >= 0).sum() > 8


@pytest.mark.parametrize("height", [7, 32])
def test_stripes_fused2_match_sw_fused_call_with_pallas2(height,
                                                         monkeypatch):
    """sw_fused_call with SMR_PALLAS=2 and the v2 kernel interpreted,
    unjitted, against both passes of v2 in stripes."""
    go, ge = 1, 3
    B, lq, lr = 512, 24, 40
    buf = testing.edge_block(np.random.default_rng(950 + height), B, lq, lr)
    monkeypatch.setenv("SMR_PALLAS", "2")
    traced = []
    orig = sw_pallas.sw_scan_pallas2

    def pallas2(*a, **kw):
        traced.append(1)
        return orig(*a, interpret=True, **kw)

    monkeypatch.setattr(sw_pallas, "sw_scan_pallas2", pallas2)
    want = np.asarray(sw_jax.sw_fused_call.__wrapped__(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, go, ge))
    assert len(traced) == 2
    got = K.stripe_fused_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                               B, lq, lr, go, ge, height, 2).numpy()
    assert np.array_equal(got, want)
    assert (want[1] >= 0).sum() > 150


def test_stripes_of_one_tile_height_are_the_plain_scan():
    """A stripe as tall as the tile is the plain version itself: the model
    adds nothing but the hand-off."""
    rng = np.random.default_rng(990)
    Q, rv, R, cv = (torch.from_numpy(a) for a in
                    testing.edge_tiles(rng, 64, 40, 32, odd=True))
    mat = torch.from_numpy(MAT)
    want = K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, False, None)
    for height in (40, 64):
        got = K.stripe_scan_plain(Q, rv, R, cv, mat, 5, 2, False, None,
                                  height)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
