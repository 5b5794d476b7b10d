"""The port's SW column scan against the JAX package, int32-exact.

The plain PyTorch versions in sortmerna_tpu_torch/ops/sw_kernels.py (what
the wrappers run on CPU tensors, and what the CUDA kernels are held
against on the card) must equal the JAX package's XLA scan (_sw_scan),
its Pallas kernel in interpret mode (sw_scan_pallas), sw_fused_call and
sw_score_batch bit for bit; TorchSwBackend on the CPU must equal
JaxSwBackend.  Inputs come from numpy.random.default_rng(seed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu.constants import scoring_matrix_5x5      # noqa: E402
from sortmerna_tpu.ops import sw_jax                        # noqa: E402
from sortmerna_tpu.ops.sw_pallas import sw_scan_pallas      # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.ops import sw_kernels as K         # noqa: E402
from sortmerna_tpu_torch.ops.sw_torch import TorchSwBackend  # noqa: E402

MAT = scoring_matrix_5x5(2, -3, 0).astype(np.int32)


def _jax_scan(Q, rv, R, cv, terminate, ts, pallas=False, gaps=(5, 2)):
    fn = sw_scan_pallas if pallas else sw_jax._sw_scan
    kw = {"interpret": True} if pallas else {}
    out = fn(jnp.asarray(Q), jnp.asarray(rv), jnp.asarray(R),
             jnp.asarray(cv), jnp.asarray(MAT), *gaps, terminate,
             None if ts is None else jnp.asarray(ts), **kw)
    return [np.asarray(o) for o in out]


def _torch_scan(Q, rv, R, cv, terminate, ts, gaps=(5, 2)):
    t = torch.from_numpy
    out = K.sw_scan_plain(t(Q), t(rv), t(R), t(cv), t(MAT), *gaps,
                          terminate, None if ts is None else t(ts))
    return [o.numpy() for o in out]


def _where_chain(R):
    """The ref chars as _sw_scan reads them: 0..3 as they are, anything
    else profile 4.  sw_scan_pallas's select chain falls through to
    profile 0 instead, so it is held on these chars, on which the two
    agree."""
    return np.where((R >= 0) & (R < 4), R, 4).astype(np.int32)


def _differs(got, want):
    return not all(np.array_equal(g, w) for g, w in zip(got, want))


def _assert_same(got, want):
    for name, g, w in zip(("best", "end_ref", "end_read"), got, want):
        assert g.dtype == np.int32, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("shape", [(64, 256, 256), (64, 128, 256),
                                   (32, 64, 128)])
@pytest.mark.parametrize("terminate", [False, True])
def test_scan_plain_matches_xla_and_pallas(shape, terminate):
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate)
    Q, rv, R, cv, _, _ = testing.scan_tiles(rng, B, Lq, Lr)
    ts = _jax_scan(Q, rv, R, cv, False, None)[0].copy() if terminate \
        else None
    want = _jax_scan(Q, rv, R, cv, terminate, ts)
    _assert_same(_torch_scan(Q, rv, R, cv, terminate, ts), want)
    _assert_same(_jax_scan(Q, rv, R, cv, terminate, ts, pallas=True),
                 want)


@pytest.mark.parametrize("terminate", [False, True])
def test_scan_plain_wide_tile_three_reduction_tiebreak(terminate):
    """Lq = 4096 is past the packed-key limit ((Lq << s) >= 2**24), so the
    JAX scan takes its 3-reduction tie-break there."""
    B, Lq, Lr = 8, 4096, 48
    rng = np.random.default_rng(40 + terminate)
    Q, rv, R, cv, _, _ = testing.scan_tiles(rng, B, Lq, Lr)
    Q[4:] = 0                  # tie-heavy rows: many equal column maxima
    R[4:] = 0
    ts = _jax_scan(Q, rv, R, cv, False, None)[0].copy() if terminate \
        else None
    _assert_same(_torch_scan(Q, rv, R, cv, terminate, ts),
                 _jax_scan(Q, rv, R, cv, terminate, ts))


@pytest.mark.parametrize("terminate", [False, True])
def test_scan_plain_matches_jax_on_odd_codes(terminate):
    """Query and ref chars in -7..15: a query char reads the profile row
    of mat.T[Q] (negative codes wrap once, then clamp), a ref char the
    where-chain's; held against _sw_scan and, on the where-chain's image
    of the ref chars, the interpreted Pallas kernel."""
    rng = np.random.default_rng(60 + terminate)
    Q, rv, R, cv, _, _ = testing.odd_tiles(rng, 64, 24, 32)
    ts = _jax_scan(Q, rv, R, cv, False, None)[0].copy() if terminate \
        else None
    want = _jax_scan(Q, rv, R, cv, terminate, ts)
    got = _torch_scan(Q, rv, R, cv, terminate, ts)
    _assert_same(got, want)
    _assert_same(got, _jax_scan(Q, rv, _where_chain(R), cv, terminate, ts,
                                pallas=True))
    # the odd query codes matter: clamped to 0..4 they give another result
    assert _differs(_torch_scan(np.clip(Q, 0, 4), rv, R, cv, terminate, ts),
                    want)


@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_scan_plain_matches_jax_on_edge_inputs(gaps, terminate):
    """testing.edge_tiles with v1's odd chars (query lengths 1..Lq in one
    block, tie-heavy pairs, holes in the row mask, chars in -7..15) at
    each edge gap pair, in terminate mode at a tscore below the forward
    best; the same inputs hold the CUDA kernel on the card."""
    rng = np.random.default_rng(300 + 10 * gaps[0] + gaps[1] + terminate)
    Q, rv, R, cv = testing.edge_tiles(rng, 128, 72, 80, odd=True)
    fw_best = _jax_scan(Q, rv, R, cv, False, None, gaps=gaps)[0]
    ts = testing.edge_tscore(rng, fw_best) if terminate else None
    want = _jax_scan(Q, rv, R, cv, terminate, ts, gaps=gaps)
    got = _torch_scan(Q, rv, R, cv, terminate, ts, gaps)
    _assert_same(got, want)
    _assert_same(got, _jax_scan(Q, rv, _where_chain(R), cv, terminate, ts,
                                pallas=True, gaps=gaps))
    assert (want[1] >= 0).sum() > 100
    if terminate:               # some scans stopped before their best
        assert (want[0] < fw_best).sum() > 5


@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_fused_plain_matches_sw_fused_call_on_edge_blocks(gaps):
    """testing.edge_block with nibbles 0..15 (read lengths 1..lq in one
    block, tie-heavy pairs, most pairs through the begin pass) at each
    edge gap pair."""
    go, ge = gaps
    B, lq, lr = 128, 64, 96
    buf = testing.edge_block(np.random.default_rng(400 + 10 * go + ge),
                             B, lq, lr, odd=True)
    want = np.asarray(sw_jax.sw_fused_call(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, go, ge))
    got = K.sw_fused_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                           B, lq, lr, go, ge).numpy()
    assert np.array_equal(got, want)
    assert (want[1] >= 0).sum() > 40


@pytest.mark.parametrize("shape", [(64, 256, 256), (32, 512, 256),
                                   (64, 256, 512)])
def test_fused_plain_matches_sw_fused_call(shape):
    B, lq, lr = shape
    rng = np.random.default_rng(sum(shape))
    buf = testing.fused_block(rng, B, lq, lr)
    want = np.asarray(sw_jax.sw_fused_call(
        jnp.asarray(buf), jnp.asarray(MAT), B, lq, lr, 5, 2))
    got = K.sw_fused_plain(torch.from_numpy(buf), torch.from_numpy(MAT),
                           B, lq, lr, 5, 2).numpy()
    assert got.dtype == np.int32 and got.shape == (5, B)
    assert np.array_equal(got, want)
    # the edge rows took their edge paths
    assert want[2, 2] == -1 and want[1, 3] == -1 and (want[1] >= 0).any()


@pytest.mark.parametrize("terminate", [False, True])
def test_score_batch_plain_matches_sw_score_batch(terminate):
    B, Lq, Lr = 48, 128, 256
    rng = np.random.default_rng(5 + terminate)
    Q, _, R, _, qlen, rlen = testing.scan_tiles(rng, B, Lq, Lr)
    Q = np.minimum(Q, 4)
    qlen = qlen.astype(np.int32)
    rlen = rlen.astype(np.int32)
    ts = None
    if terminate:
        ts = np.asarray(sw_jax.sw_score_batch(
            jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(R),
            jnp.asarray(rlen), jnp.asarray(MAT), 5, 2)[0])
    want = sw_jax.sw_score_batch(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(R),
        jnp.asarray(rlen), jnp.asarray(MAT), 5, 2, terminate=terminate,
        tscore=None if ts is None else jnp.asarray(ts))
    t = torch.from_numpy
    got = K.sw_score_batch_plain(t(Q), t(qlen), t(R), t(rlen), t(MAT), 5,
                                 2, terminate=terminate,
                                 tscore=None if ts is None else t(ts))
    _assert_same([g.numpy() for g in got], [np.asarray(w) for w in want])


def _score_batch(fn, Q, qlen, R, rlen, terminate, ts):
    conv = jnp.asarray if fn is sw_jax.sw_score_batch else torch.from_numpy
    out = fn(conv(Q), conv(qlen), conv(R), conv(rlen), conv(MAT), 5, 2,
             terminate=terminate, tscore=None if ts is None else conv(ts))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("terminate", [False, True])
def test_score_batch_plain_matches_sw_score_batch_on_odd_codes(terminate):
    """Query and ref chars in -7..15: the query reads mat.T[Q]'s row, the
    ref take_along_axis's (-5..-1 wrap; any other code outside 0..4 reads
    INT32_MIN, a valid column that scores nothing on its diagonal)."""
    rng = np.random.default_rng(70 + terminate)
    Q, _, R, _, qlen, rlen = testing.odd_tiles(rng, 48, 24, 32)
    ts = _score_batch(sw_jax.sw_score_batch, Q, qlen, R, rlen, False,
                      None)[0].copy() if terminate else None
    want = _score_batch(sw_jax.sw_score_batch, Q, qlen, R, rlen, terminate,
                        ts)
    got = _score_batch(K.sw_score_batch_plain, Q, qlen, R, rlen, terminate,
                       ts)
    _assert_same(got, want)
    # the odd ref codes matter: clamped to 0..4 they give another result
    assert _differs(_score_batch(K.sw_score_batch_plain, Q, qlen,
                                 np.clip(R, 0, 4), rlen, terminate, ts),
                    want)


def _coord_jobs(seed, n):
    """Random coordinate jobs over concatenated read / ref buffers, some
    true matches, some junk, lengths spread over two length buckets."""
    rng = np.random.default_rng(seed)
    q_len = rng.integers(1, 300, n).astype(np.int32)
    r_len = (q_len + rng.integers(0, 60, n)).astype(np.int32)
    q_off = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int64)
    r_off = np.concatenate([[0], np.cumsum(r_len)[:-1]]).astype(np.int64)
    q_data = rng.integers(0, 5, int(q_len.sum())).astype(np.uint8)
    r_data = rng.integers(0, 5, int(r_len.sum())).astype(np.uint8)
    for i in range(0, n, 2):
        k = int(q_len[i])
        r_data[r_off[i] + 3:r_off[i] + 3 + min(k, int(r_len[i]) - 3)] = \
            q_data[q_off[i]:q_off[i] + min(k, int(r_len[i]) - 3)]
    minimal = rng.integers(10, 60, n).astype(np.int32)
    return q_data, q_off, q_len, r_data, r_off, r_len, minimal


@pytest.mark.parametrize("method", ["batch_coords",
                                    "batch_coords_hostgather"])
def test_backend_coords_match_jax_backend(method):
    jobs = _coord_jobs(11, 300)
    want = getattr(sw_jax.JaxSwBackend(MAT, 5, 2), method)(*jobs)
    got = getattr(TorchSwBackend(MAT, 5, 2, device="cpu"), method)(*jobs)
    for name, g, w in zip(("score", "beg_ref", "end_ref", "beg_read",
                           "end_read"), got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name


def test_backend_batch_jobs_match_jax_backend():
    from sortmerna_tpu.engine.candidates import SwJob
    q_data, q_off, q_len, r_data, r_off, r_len, minimal = _coord_jobs(3, 40)
    jobs = [SwJob(query=q_data[q_off[i]:q_off[i] + q_len[i]],
                  ref=r_data[r_off[i]:r_off[i] + r_len[i]],
                  minimal_score=int(minimal[i])) for i in range(40)]
    want = sw_jax.JaxSwBackend(MAT, 5, 2).batch(jobs)
    got = TorchSwBackend(MAT, 5, 2, device="cpu").batch(jobs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "cigar":
                assert (g[k] is None) == (w[k] is None)
                if w[k] is not None:
                    assert list(g[k]) == list(w[k])
            else:
                assert g[k] == w[k], k


def test_cpu_block_cut_matches_the_unsplit_block():
    """A block that mixes a job of a 30,000-nt ref with short ones: the
    CPU backend cuts it at the ref-length bucket (two launches of the
    plain version), and its results equal the unsplit block's."""
    rng = np.random.default_rng(17)
    r_len = np.array([30000, 180, 150, 140, 120], np.int32)
    q_len = np.array([200, 100, 90, 80, 70], np.int32)
    q_off = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int64)
    r_off = np.concatenate([[0], np.cumsum(r_len)[:-1]]).astype(np.int64)
    q_data = rng.integers(0, 4, int(q_len.sum())).astype(np.uint8)
    r_data = rng.integers(0, 4, int(r_len.sum())).astype(np.uint8)
    for i, at in enumerate((100, 40, 30, 20, 10)):
        k = int(q_len[i])
        r_data[r_off[i] + at:r_off[i] + at + k] = \
            q_data[q_off[i]:q_off[i] + k]
    minimal = np.full(5, 20, np.int32)
    jobs = (q_data, q_off, q_len, r_data, r_off, r_len, minimal)
    cut = TorchSwBackend(MAT, 5, 2, device="cpu")
    whole = TorchSwBackend(MAT, 5, 2, device="cpu")
    whole._cpu_block = lambda ba, r_len: ba
    got, want = (b.batch_coords_submit(*jobs) for b in (cut, whole))
    assert [len(ba) for ba, _ in got[0]] == [1, 4]
    assert [len(ba) for ba, _ in want[0]] == [5]
    got, want = (TorchSwBackend.batch_coords_fetch(h) for h in (got, want))
    assert list(got[0]) == [2 * int(n) for n in q_len]
    for name, g, w in zip(("score", "beg_ref", "end_ref", "beg_read",
                           "end_read"), got, want):
        assert np.array_equal(g, w), name


def test_cpu_tensors_take_the_plain_version_without_counting():
    K.reset_launches()
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(testing.fused_block(rng, 64, 256, 256))
    mat = torch.from_numpy(MAT)
    out = K.sw_fused(buf, mat, 64, 256, 256, 5, 2)
    assert torch.equal(out, K.sw_fused_plain(buf, mat, 64, 256, 256, 5, 2))
    out = K.sw_fused2(buf, mat, 64, 256, 256, 5, 2)
    assert torch.equal(out, K.sw_fused2_plain(buf, mat, 64, 256, 256, 5, 2))
    assert K.LAUNCHES == {"sw_scan": 0, "sw_fused": 0, "sw_scan2": 0,
                          "sw_fused2": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 140), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        K.sw_fused(meta, torch.from_numpy(MAT), 4, 256, 0, 5, 2)
    q = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        K.sw_scan(q, q.bool(), q, q.bool(), q, 5, 2, False)
