"""The CUDA kernels against their plain PyTorch versions, on the card.

Int32-exact (the seed probe: the same arrays in the same order), at small
shapes that reach both routes of the SW kernels (a warp a pair with its
rows in registers for Lq <= 1024; above, the long-tile route: a pair's
rows in stripes over the warps of a CTA, and over the CTAs of a cluster
past 8,192 rows), query and ref codes in -7..15
(``testing.odd_tiles``), the odd inputs of v2 and the edge inputs of
``testing.edge_tiles`` / ``edge_block`` (with v1's odd chars for the v1
entries).  While working on csrc/sw_scan.cu or csrc/sw_wave.cuh,
``-k "scan or fused or long"`` runs the SW kernels' tests alone.  Every
test is marked ``cuda`` and skips without a GPU.  The JAX package is not
needed, so on a machine without JAX run them past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.constants import scoring_matrix_5x5  # noqa: E402
from sortmerna_tpu_torch.ops import sw_kernels as K         # noqa: E402
from sortmerna_tpu_torch.ops.sw_torch import TorchSwBackend  # noqa: E402

pytestmark = pytest.mark.cuda

MAT = scoring_matrix_5x5(2, -3, 0).astype(np.int32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.int32, i
        assert torch.equal(g.cpu(), w.cpu()), i


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 512, 256),
                                   (32, 2048, 128), (16, 4096, 64)])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan_kernel_matches_plain(cuda, shape, terminate):
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.scan_tiles(rng, B, Lq, Lr)[:4])
    mat = torch.from_numpy(MAT).to(cuda)
    ts = K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, False, None)[0] \
        if terminate else None
    before = K.LAUNCHES["sw_scan"]
    got = K.sw_scan(Q, rv, R, cv, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sw_scan"] == before + 1
    _same(got, K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, terminate, ts))


@pytest.mark.parametrize("shape", [(1024, 256, 256), (512, 2048, 128)])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan_kernel_matches_plain_on_odd_codes(cuda, shape, terminate):
    """Query and ref codes in -7..15, on both routes."""
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate + 1)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.odd_tiles(rng, B, Lq, Lr)[:4])
    mat = torch.from_numpy(MAT).to(cuda)
    ts = K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, False, None)[0] \
        if terminate else None
    got = K.sw_scan(Q, rv, R, cv, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    _same(got, K.sw_scan_plain(Q, rv, R, cv, mat, 5, 2, terminate, ts))


@pytest.mark.parametrize("shape", [(1024, 256, 256), (512, 2048, 128)])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_score_batch_kernel_matches_plain(cuda, shape, terminate):
    """sw_score_batch through the v1 kernel (the ref chars read by
    take_along_axis) against its plain twin, codes in -7..15."""
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate + 2)
    Q, _, R, _, qlen, rlen = testing.odd_tiles(rng, B, Lq, Lr)
    Q, R, qlen, rlen = (torch.from_numpy(a).to(cuda)
                        for a in (Q, R, qlen, rlen))
    mat = torch.from_numpy(MAT).to(cuda)
    ts = K.sw_score_batch_plain(Q, qlen, R, rlen, mat, 5, 2)[0] \
        if terminate else None
    before = K.LAUNCHES["sw_scan"]
    got = K.sw_score_batch(Q, qlen, R, rlen, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sw_scan"] == before + 1
    _same(got, K.sw_score_batch_plain(Q, qlen, R, rlen, mat, 5, 2,
                                      terminate, ts))


@pytest.mark.parametrize("shape", [(4096, 256, 256), (1024, 1024, 256),
                                   (1024, 2048, 160), (1024, 2048, 256)])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan_kernel_matches_plain_on_edge_inputs(cuda, shape, gaps,
                                                     terminate):
    """testing.edge_tiles with v1's odd chars (query lengths 1..Lq in one
    launch, tie-heavy pairs, holes in the row mask, codes in -7..15), go <
    ge and zero gaps, a tscore below the forward best; Lq = 2048 takes the
    long-tile route (4 warps a pair, the MASK layout)."""
    B, Lq, Lr = shape
    go, ge = gaps
    rng = np.random.default_rng(Lq + 10 * go + ge + terminate + 3)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.edge_tiles(rng, B, Lq, Lr, odd=True))
    mat = torch.from_numpy(MAT).to(cuda)
    ts = None
    if terminate:
        best = K.sw_scan_plain(Q, rv, R, cv, mat, go, ge, False, None)[0]
        ts = torch.from_numpy(testing.edge_tscore(rng, best.cpu().numpy())) \
            .to(cuda)
    got = K.sw_scan(Q, rv, R, cv, mat, go, ge, terminate, ts)
    torch.cuda.synchronize()
    _same(got, K.sw_scan_plain(Q, rv, R, cv, mat, go, ge, terminate, ts))


@pytest.mark.parametrize("shape", [(4096, 256, 256), (1024, 1024, 256),
                                   (1024, 2048, 256)])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_sw_fused_kernel_matches_plain_on_edge_blocks(cuda, shape, gaps):
    """testing.edge_block with nibbles 0..15: read lengths 1..lq in one
    launch, tie-heavy pairs, most pairs through the begin pass, at each
    edge gap pair."""
    B, lq, lr = shape
    go, ge = gaps
    buf = torch.from_numpy(testing.edge_block(
        np.random.default_rng(lq + 10 * go + ge + 4), B, lq, lr,
        odd=True)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    before = K.LAUNCHES["sw_fused"]
    got = K.sw_fused(buf, mat, B, lq, lr, go, ge)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sw_fused"] == before + 1
    _same(got, K.sw_fused_plain(buf, mat, B, lq, lr, go, ge))


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 512, 512),
                                   (16, 2048, 1024), (4096, 256, 256),
                                   (64, 1024, 512), (64, 1056, 256)])
def test_sw_fused_kernel_matches_plain(cuda, shape):
    B, lq, lr = shape
    rng = np.random.default_rng(sum(shape))
    buf = torch.from_numpy(testing.fused_block(rng, B, lq, lr)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    got = K.sw_fused(buf, mat, B, lq, lr, 5, 2)
    torch.cuda.synchronize()
    _same(got, K.sw_fused_plain(buf, mat, B, lq, lr, 5, 2))


@pytest.mark.parametrize("shape", [(1024, 256, 256), (512, 2048, 128)])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan2_kernel_matches_plain_on_odd_codes(cuda, shape, terminate):
    """Query and ref codes in -7..15 (negative query codes wrap), on both
    routes."""
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate + 5)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.odd_tiles(rng, B, Lq, Lr)[:4])
    mat = torch.from_numpy(MAT).to(cuda)
    ts = K.sw_scan2_plain(Q, rv, R, cv, mat, 5, 2, False, None)[0] \
        if terminate else None
    got = K.sw_scan2(Q, rv, R, cv, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    _same(got, K.sw_scan2_plain(Q, rv, R, cv, mat, 5, 2, terminate, ts))


@pytest.mark.parametrize("shape", [(512, 256, 256), (1024, 64, 136),
                                   (512, 4096, 64), (4096, 256, 256),
                                   (512, 1024, 96), (512, 1056, 64),
                                   (512, 2048, 64)])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan2_kernel_matches_plain(cuda, shape, terminate):
    """The v2 kernel: a second 512-pair block, a tile whose last 128-column
    chunk is clamped, ref chars outside 0..4, the 3-reduction tie-break
    of Lq = 4096, the main path's block shape, 32 rows a lane (Lq =
    1024) and the long-tile route of tiles over 1,024 rows."""
    B, Lq, Lr = shape
    rng = np.random.default_rng(B + Lq + Lr + terminate)
    Q, rv, R, cv = testing.scan_tiles(rng, B, Lq, Lr)[:4]
    odd = rng.random(R.shape) < 0.02
    R[odd] = rng.choice([-2, 5, 7, 9], int(odd.sum()))
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda) for a in (Q, rv, R, cv))
    mat = torch.from_numpy(MAT).to(cuda)
    ts = K.sw_scan2_plain(Q, rv, R, cv, mat, 5, 2, False, None)[0] \
        if terminate else None
    before = K.LAUNCHES["sw_scan2"]
    got = K.sw_scan2(Q, rv, R, cv, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sw_scan2"] == before + 1
    _same(got, K.sw_scan2_plain(Q, rv, R, cv, mat, 5, 2, terminate, ts))


@pytest.mark.parametrize("shape", [(512, 256, 256), (300, 256, 256),
                                   (700, 512, 136), (16, 2048, 1024),
                                   (4096, 256, 256), (64, 1024, 512),
                                   (64, 1056, 256)])
def test_sw_fused2_kernel_matches_plain(cuda, shape):
    """Any B (a ragged last block), nibbles 5..15 in the windows of one
    pair in ten; the main path's block shape, 32 rows a lane (lq =
    1024) and the long-tile route of tiles over 1,024 rows."""
    B, lq, lr = shape
    rng = np.random.default_rng(sum(shape) + 2)
    buf = testing.fused_block(rng, B, lq, lr)
    odd = (rng.random((B, 1)) < 0.1) \
        & (rng.random((B, lq // 2 + lr // 2)) < 0.05)
    buf[:, :lq // 2 + lr // 2][odd] = rng.integers(0x50, 0x100,
                                                   int(odd.sum()))
    buf = torch.from_numpy(buf).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    before = K.LAUNCHES["sw_fused2"]
    got = K.sw_fused2(buf, mat, B, lq, lr, 5, 2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sw_fused2"] == before + 1
    _same(got, K.sw_fused2_plain(buf, mat, B, lq, lr, 5, 2))


@pytest.mark.parametrize("Lq", [256, 1024, 2048])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan2_kernel_matches_plain_on_edge_inputs(cuda, Lq, gaps,
                                                      terminate):
    """testing.edge_tiles (query lengths 1..Lq in one launch, so every
    count of rows a lane from 1 to Lq / 32; tie-heavy pairs, holes in the
    row mask), go < ge and zero gaps, a tscore below the forward best;
    Lq = 2048 takes the long-tile route."""
    go, ge = gaps
    rng = np.random.default_rng(Lq + 10 * go + ge + terminate)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.edge_tiles(rng, 1024, Lq, 160))
    mat = torch.from_numpy(MAT).to(cuda)
    ts = None
    if terminate:
        best = K.sw_scan2_plain(Q, rv, R, cv, mat, go, ge, False, None)[0]
        ts = torch.from_numpy(testing.edge_tscore(rng, best.cpu().numpy())) \
            .to(cuda)
    got = K.sw_scan2(Q, rv, R, cv, mat, go, ge, terminate, ts)
    torch.cuda.synchronize()
    _same(got, K.sw_scan2_plain(Q, rv, R, cv, mat, go, ge, terminate, ts))


@pytest.mark.parametrize("lq", [256, 1024, 2048])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_sw_fused2_kernel_matches_plain_on_edge_blocks(cuda, lq, gaps):
    """testing.edge_block: read lengths 1..lq in one launch, tie-heavy
    pairs, most pairs through the begin pass, at each edge gap pair."""
    go, ge = gaps
    B, lr = 1024, 256
    buf = torch.from_numpy(testing.edge_block(
        np.random.default_rng(lq + 10 * go + ge), B, lq, lr)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    got = K.sw_fused2(buf, mat, B, lq, lr, go, ge)
    torch.cuda.synchronize()
    _same(got, K.sw_fused2_plain(buf, mat, B, lq, lr, go, ge))


# The long-tile route: a CTA of 4 warps a pair (2,048 rows), of 16 warps
# (8,192), a cluster of 4 CTAs (32,768); sw_scan2 takes B in 512s.
LONG_SHAPES = [(16, 2048, 1024), (4, 8192, 512), (2, 32768, 256)]
LONG_SHAPES2 = [(512, 2048, 128), (512, 8192, 64), (512, 32768, 16)]


def _scan_pair(version):
    return {1: (K.sw_scan, K.sw_scan_plain, "sw_scan"),
            2: (K.sw_scan2, K.sw_scan2_plain, "sw_scan2")}[version]


def _fused_pair(version):
    return {1: (K.sw_fused, K.sw_fused_plain, "sw_fused"),
            2: (K.sw_fused2, K.sw_fused2_plain, "sw_fused2")}[version]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("at", [0, 1, 2])
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan_long_tiles_match_plain(cuda, version, at, terminate):
    """Both scan entries on the long-tile route, over a CTA and over a
    cluster: random tiles with ragged masks and pairs of one row."""
    B, Lq, Lr = (LONG_SHAPES, LONG_SHAPES2)[version - 1][at]
    kernel, plain, name = _scan_pair(version)
    rng = np.random.default_rng(Lq + Lr + 7 * version + terminate)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda)
                    for a in testing.scan_tiles(rng, B, Lq, Lr)[:4])
    mat = torch.from_numpy(MAT).to(cuda)
    ts = plain(Q, rv, R, cv, mat, 5, 2, False, None)[0] if terminate \
        else None
    before = K.LAUNCHES[name]
    got = kernel(Q, rv, R, cv, mat, 5, 2, terminate, ts)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    _same(got, plain(Q, rv, R, cv, mat, 5, 2, terminate, ts))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("shape", LONG_SHAPES)
@pytest.mark.parametrize("block", ["long", "short"])
def test_sw_fused_long_tiles_match_plain(cuda, version, shape, block):
    """Both fused entries on the long-tile route: long true matches (every
    pair through the begin pass, spans of the whole tile) and the align
    task's short reads in a long tile (one stripe a pair)."""
    B, lq, lr = shape
    kernel, plain, name = _fused_pair(version)
    rng = np.random.default_rng(lq + lr + version)
    make = testing.long_block if block == "long" else testing.fused_block
    buf = torch.from_numpy(make(rng, B, lq, lr)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    before = K.LAUNCHES[name]
    got = kernel(buf, mat, B, lq, lr, 5, 2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    want = plain(buf, mat, B, lq, lr, 5, 2)
    _same(got, want)
    if block == "long":
        assert (want[1] >= 0).all()


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("lq", [2048, 16384])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
def test_sw_fused_long_tiles_on_ragged_edge_blocks(cuda, version, lq, gaps):
    """testing.edge_block on the long-tile route: read lengths 1..lq in one
    launch, so pairs span from one stripe to every warp of the CTA (2,048
    rows: 1-4 stripes) or of the cluster (16,384 rows: 1-32), at each edge
    gap pair, with the odd nibbles of v1's reads."""
    go, ge = gaps
    B, lr = (256, 256) if lq == 2048 else (64, 128)
    kernel, plain, _ = _fused_pair(version)
    buf = torch.from_numpy(testing.edge_block(
        np.random.default_rng(lq + 10 * go + ge + version), B, lq, lr,
        odd=version == 1)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    got = kernel(buf, mat, B, lq, lr, go, ge)
    torch.cuda.synchronize()
    _same(got, plain(buf, mat, B, lq, lr, go, ge))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("gaps", testing.EDGE_GAPS)
@pytest.mark.parametrize("terminate", [False, True])
def test_sw_scan_long_edge_inputs_over_a_cluster(cuda, version, gaps,
                                                 terminate):
    """testing.edge_tiles at 16,384 rows (a cluster of 2 CTAs): query
    lengths 1..Lq, holes in the row mask (the MASK layout), tie-heavy
    pairs, a tscore below the forward best, so the bottom stripe stops
    the stripes above it mid-scan."""
    go, ge = gaps
    B = 64 if version == 1 else 512
    kernel, plain, _ = _scan_pair(version)
    rng = np.random.default_rng(16384 + 10 * go + ge + terminate + version)
    Q, rv, R, cv = (torch.from_numpy(a).to(cuda) for a in testing.edge_tiles(
        rng, B, 16384, 64, odd=version == 1))
    mat = torch.from_numpy(MAT).to(cuda)
    ts = None
    if terminate:
        best = plain(Q, rv, R, cv, mat, go, ge, False, None)[0]
        ts = torch.from_numpy(testing.edge_tscore(rng, best.cpu().numpy())) \
            .to(cuda)
    got = kernel(Q, rv, R, cv, mat, go, ge, terminate, ts)
    torch.cuda.synchronize()
    _same(got, plain(Q, rv, R, cv, mat, go, ge, terminate, ts))


@pytest.mark.parametrize("lq", [2048, 32768])
def test_sw_long_tiles_padding_only_blocks(cuda, lq):
    """Blocks of padding pairs only (q_len 0, an empty row mask): every CTA
    of a cluster reaches every cluster barrier and the launch ends."""
    B, lr = 8, 256
    mat = torch.from_numpy(MAT).to(cuda)
    z = np.zeros(B, np.int32)
    buf = torch.from_numpy(testing.pack_block(
        np.zeros((B, lq), np.int32), np.ones((B, lr), np.int32), z,
        z + lr, z + 10)).to(cuda)
    for version in (1, 2):
        kernel, plain, _ = _fused_pair(version)
        got = kernel(buf, mat, B, lq, lr, 5, 2)
        torch.cuda.synchronize()
        _same(got, plain(buf, mat, B, lq, lr, 5, 2))
    for version in (1, 2):
        kernel, plain, _ = _scan_pair(version)
        Bs = 512 if version == 2 else B
        Q = torch.zeros((Bs, lq), dtype=torch.int32, device=cuda)
        rv = torch.zeros((Bs, lq), dtype=torch.bool, device=cuda)
        R = torch.ones((Bs, lr), dtype=torch.int32, device=cuda)
        cv = torch.ones((Bs, lr), dtype=torch.bool, device=cuda)
        got = kernel(Q, rv, R, cv, mat, 5, 2, False, None)
        torch.cuda.synchronize()
        _same(got, plain(Q, rv, R, cv, mat, 5, 2, False, None))


def test_sw_long_geometry(cuda):
    """The long-tile route's launch: 512 rows a warp at most, one CTA of up
    to 16 warps, then clusters of 2, 4 and 8 CTAs; none on the register
    path."""
    assert K.long_geometry(1024) == (0, 0)
    assert K.long_geometry(1056) == (3, 1)
    assert K.long_geometry(2048) == (4, 1)
    assert K.long_geometry(8192) == (16, 1)
    assert K.long_geometry(8193) == (9, 2)
    assert K.long_geometry(16384) == (16, 2)
    assert K.long_geometry(32768) == (16, 4)
    assert K.long_geometry(65536) == (16, 8)


def test_sw_long_tiles_refuse_past_max_rows(cuda):
    """A tile wider than the largest cluster holds raises; nothing falls
    back."""
    lq, lr, B = K.MAX_ROWS + 2, 2, 1
    buf = torch.zeros((B, lq // 2 + lr // 2 + 12), dtype=torch.uint8,
                      device=cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    for fn in (K.sw_fused, K.sw_fused2):
        with pytest.raises(ValueError, match="query rows"):
            fn(buf, mat, B, lq, lr, 5, 2)


@pytest.fixture(scope="module")
def probe_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("probe") / "db.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1400),
                           seed=3)
    return db, seqs


@pytest.fixture(scope="module")
def probe_part(probe_db):
    from sortmerna_tpu_torch.index.builder import build_index
    return build_index(probe_db[0]).parts[0], probe_db[1]


def _probe_windows(seqs, n, seed, L=18):
    """Windows of L nt cut from the reference (with 0-3 point edits) and
    random ones, as packed (L/2)-mer halves."""
    rng = np.random.default_rng(seed)
    code = np.zeros(256, np.int64)
    code[list(b"ACGT")] = [0, 1, 2, 3]
    pw = L // 2
    weights = 4 ** np.arange(pw - 1, -1, -1)
    w1, w2 = [], []
    while len(w1) < n:
        e = code[np.frombuffer(seqs[int(rng.integers(len(seqs)))],
                               np.uint8)]
        st = int(rng.integers(0, len(e) - L))
        w = e[st:st + L].copy()
        for _ in range(int(rng.integers(0, 4))):
            w[rng.integers(0, L)] = rng.integers(0, 4)
        if rng.random() < 0.2:
            w = rng.integers(0, 4, L)
        w1.append(int(w[:pw] @ weights))
        w2.append(int(w[pw:] @ weights))
    return np.asarray(w1, np.int64), np.asarray(w2, np.int64)


@pytest.mark.parametrize("full_search", [False, True])
@pytest.mark.parametrize("minoccur", [0, 2])
def test_seed_probe_kernels_match_plain(cuda, probe_part, full_search,
                                        minoccur):
    from sortmerna_tpu_torch.ops import seed_search as S
    part, seqs = probe_part
    w1, w2 = _probe_windows(seqs, 5003, seed=full_search + 2 * minoccur)
    before = dict(S.LAUNCHES)
    got = S.DeviceSeedSearcher(part, minoccur, full_search, device=cuda) \
        .search_windows(w1, w2)
    assert S.LAUNCHES["seed_probe"] == before["seed_probe"] + 1
    assert S.LAUNCHES["seed_compact"] == before["seed_compact"] + 1
    want = S.DeviceSeedSearcher(part, minoccur, full_search, device="cpu") \
        .search_windows(w1, w2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        assert np.array_equal(g, w)
    assert len(want[0]) > 1000


@pytest.mark.parametrize("L", [8, 12, 14, 22, 26])
def test_seed_probe_kernels_match_plain_at_seed_lengths(cuda, probe_db, L):
    """The other instantiations of seed_probe_kernel<NP> (NP = 2, 3, 4, 5,
    6 probes a lane at these seed lengths; 18 is NP = 4 too), both
    modes."""
    from sortmerna_tpu_torch.index.builder import build_index
    from sortmerna_tpu_torch.ops import seed_search as S
    db, seqs = probe_db
    part = build_index(db, seed_win_len=L).parts[0]
    w1, w2 = _probe_windows(seqs, 3001, seed=L, L=L)
    for full_search in (False, True):
        got = S.DeviceSeedSearcher(part, 0, full_search, device=cuda) \
            .search_windows(w1, w2)
        want = S.DeviceSeedSearcher(part, 0, full_search, device="cpu") \
            .search_windows(w1, w2)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert len(want[0]) > 300


@pytest.mark.parametrize("name", ["chains", "groups", "full"])
@pytest.mark.parametrize("full_search", [False, True])
def test_seed_probe_kernels_match_plain_on_edges(cuda, name, full_search):
    """Both kernels on the probe edge inputs (``testing.probe_edges``):
    chains at and past MAX_PROBES, wrapping or without EMPTY, groups at
    the caps, 31..376 ids a window, clamped r_ids starts, gates, modes."""
    from sortmerna_tpu_torch.ops import seed_search as S
    c = {e["name"]: e for e in testing.probe_edges()}[name]
    pw, mo = c["pw"], c["minoccur"]
    host = {k: torch.from_numpy(v) for k, v in c["tabs"].items()}
    tabs = S.with_home_bits({k: v.to(cuda) for k, v in host.items()})
    w1, w2 = (torch.from_numpy(c[k].astype(np.int32)) for k in ("w1", "w2"))
    count, ids = S.seed_probe(tabs, w1.to(cuda), w2.to(cuda), pw,
                              full_search, mo)
    want_count, want_ids = S.seed_probe_plain(host, w1.long(), w2.long(),
                                              pw, full_search, mo)
    assert torch.equal(count.cpu(), want_count)
    keep = torch.arange(ids.shape[1])[None] < want_count.long()[:, None]
    assert torch.equal(ids.cpu()[keep], want_ids[keep])
    win, got, total = S.seed_compact(count, ids, pw)
    want = S.seed_compact_plain(want_count, want_ids)
    n = int(total[0])
    assert n == len(want[0]) > 50
    assert torch.equal(win[:n].cpu(), want[0])
    assert torch.equal(got[:n].cpu(), want[1])


@pytest.mark.parametrize("nw, pw", [(1, 9), (1023, 9), (1024, 9),
                                    (1025, 9), (65536, 9), (100000, 2)])
def test_seed_compact_scans_its_counts(cuda, nw, pw):
    """seed_compact's own scan (1024-window blocks, a look-back over 32
    blocks at a time) on random counts, zeros and full rows included, into
    given buffers."""
    from sortmerna_tpu_torch.ops import seed_search as S
    rng = np.random.default_rng(nw)
    K = S.ids_per_window(pw)
    count = rng.integers(0, 4, nw)
    count[rng.random(nw) < 0.3] = 0
    count[rng.random(nw) < 0.001] = K
    ids = rng.integers(-2**31, 2**31 - 1, (nw, K)).astype(np.int32)
    count = torch.from_numpy(count.astype(np.int32))
    ids = torch.from_numpy(ids)
    out = tuple(torch.full((n,), -5, dtype=torch.int32, device=cuda)
                for n in (nw * K, nw * K, 1)) \
        + (torch.full((S.compact_state_words(nw),), -5, dtype=torch.int64,
                      device=cuda),)
    win, got, total = S.seed_compact(count.to(cuda), ids.to(cuda), pw,
                                     out=out)
    assert win is out[0] and got is out[1] and total is out[2]
    want = S.seed_compact_plain(count, ids)
    n = int(total[0])
    assert n == int(count.sum()) == len(want[0])
    assert torch.equal(win[:n].cpu(), want[0])
    assert torch.equal(got[:n].cpu(), want[1])


@pytest.fixture(scope="module")
def thread_windows(probe_db, tmp_path_factory):
    """Two window sets of different sizes, each cut from its own reads of
    the probe DB as chip_smoke's probe phase cuts them."""
    top = tmp_path_factory.mktemp("threads")
    sets = []
    for i, n in enumerate((5003, 3001)):
        reads = str(top / f"reads{i}.fasta")
        testing.make_reads(reads, probe_db[1], 400, seed=40 + i)
        sets.append(testing.read_windows(reads, 18, n, seed=50 + i))
    return sets


def test_searcher_threads_do_not_share_outputs(cuda, probe_part,
                                               thread_windows, monkeypatch):
    """One searcher, two threads (read shards share their part's
    searcher): each thread's results are its own windows' serial results.
    First 50 searches a thread side by side, then a forced interleave:
    thread A stops after its launches (probe_windows returns) until
    thread B's whole search is done or 2 s have passed.  Without the
    searcher's lock B's kernels overwrite the shared output buffers
    before A copies them, and A reads B's windows."""
    import threading
    from sortmerna_tpu_torch.ops import seed_search as S
    searcher = S.DeviceSeedSearcher(probe_part[0], 0, False, device=cuda)
    want = [searcher.search_windows(*ws) for ws in thread_windows]
    assert len(want[0][0]) != len(want[1][0]) and len(want[1][0]) > 300
    wrong = [0, 0]

    def loop(i):
        for _ in range(50):
            got = searcher.search_windows(*thread_windows[i])
            wrong[i] += not all(np.array_equal(g, w)
                                for g, w in zip(got, want[i]))

    ths = [threading.Thread(target=loop, args=(i,)) for i in (0, 1)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(300)
    assert not any(t.is_alive() for t in ths)

    a_launched, b_done = threading.Event(), threading.Event()
    orig = S.probe_windows

    def probe_windows(*a, **kw):
        out = orig(*a, **kw)
        if threading.current_thread().name == "A":
            a_launched.set()
            b_done.wait(2)
        return out

    monkeypatch.setattr(S, "probe_windows", probe_windows)
    got = {}

    def search(name, i):
        if name == "B":
            a_launched.wait(60)
        got[name] = searcher.search_windows(*thread_windows[i])
        if name == "B":
            b_done.set()

    ths = [threading.Thread(target=search, args=(n, i), name=n)
           for n, i in (("A", 0), ("B", 1))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    assert not any(t.is_alive() for t in ths)
    mixed = [name for name, i in (("A", 0), ("B", 1))
             if not all(np.array_equal(g, w)
                        for g, w in zip(got[name], want[i]))]
    # wrong searches of the 50 a thread; threads whose forced search
    # read another's windows
    assert (wrong, mixed) == ([0, 0], [])


@pytest.mark.parametrize("pallas", [None, "2"])
def test_backend_on_cuda_matches_cpu(cuda, pallas, monkeypatch):
    """The wave path on both kernels: sw_fused, and sw_fused2 with
    SMR_PALLAS=2."""
    if pallas:
        monkeypatch.setenv("SMR_PALLAS", pallas)
    else:
        monkeypatch.delenv("SMR_PALLAS", raising=False)
    kernel = "sw_fused2" if pallas else "sw_fused"
    rng = np.random.default_rng(17)
    n = 700
    q_len = rng.integers(1, 400, n).astype(np.int32)
    r_len = (q_len + rng.integers(0, 80, n)).astype(np.int32)
    q_off = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int64)
    r_off = np.concatenate([[0], np.cumsum(r_len)[:-1]]).astype(np.int64)
    q_data = rng.integers(0, 5, int(q_len.sum())).astype(np.uint8)
    r_data = rng.integers(0, 5, int(r_len.sum())).astype(np.uint8)
    for i in range(0, n, 2):
        k = max(min(int(q_len[i]), int(r_len[i]) - 2), 0)
        r_data[r_off[i] + 2:r_off[i] + 2 + k] = q_data[q_off[i]:q_off[i] + k]
    minimal = rng.integers(10, 60, n).astype(np.int32)
    jobs = (q_data, q_off, q_len, r_data, r_off, r_len, minimal)
    K.reset_launches()
    got = TorchSwBackend(MAT, 5, 2, device="cuda").batch_coords(*jobs)
    assert K.LAUNCHES[kernel] == 1         # 700 jobs fit one block
    assert sum(K.LAUNCHES.values()) == 1
    want = TorchSwBackend(MAT, 5, 2, device="cpu").batch_coords(*jobs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _wave_jobs(rng, n):
    """SW jobs as the part driver hands them over: concatenated reads and
    ref windows, every other pair a true match, ragged lengths."""
    q_len = rng.integers(1, 400, n).astype(np.int32)
    r_len = (q_len + rng.integers(0, 80, n)).astype(np.int32)
    q_off = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int64)
    r_off = np.concatenate([[0], np.cumsum(r_len)[:-1]]).astype(np.int64)
    q_data = rng.integers(0, 5, int(q_len.sum())).astype(np.uint8)
    r_data = rng.integers(0, 5, int(r_len.sum())).astype(np.uint8)
    for i in range(0, n, 2):
        k = max(min(int(q_len[i]), int(r_len[i]) - 2), 0)
        r_data[r_off[i] + 2:r_off[i] + 2 + k] = q_data[q_off[i]:q_off[i] + k]
    minimal = rng.integers(10, 60, n).astype(np.int32)
    return q_data, q_off, q_len, r_data, r_off, r_len, minimal


def test_backend_threads_match_serial(cuda):
    """Four threads submit and fetch their own waves on one backend (the
    overlap scheduler's workers and read shards share it), two waves in
    flight a thread: every result equals that wave's serial result and
    the plain version's."""
    import threading
    rng = np.random.default_rng(37)
    waves = [_wave_jobs(rng, n) for n in (700, 4500, 300, 1900)]
    backend = TorchSwBackend(MAT, 5, 2, device=cuda)
    plain = TorchSwBackend(MAT, 5, 2, device="cpu")
    want = [backend.batch_coords(*jobs) for jobs in waves]
    for w, jobs in zip(want, waves):
        for g, p in zip(w, plain.batch_coords(*jobs)):
            assert np.array_equal(g, p)
    wrong = [0] * 4

    def loop(i):
        for _ in range(10):
            hs = [backend.batch_coords_submit(*waves[i]) for _ in range(2)]
            for h in hs:
                got = backend.batch_coords_fetch(h)
                wrong[i] += not all(np.array_equal(g, w)
                                    for g, w in zip(got, want[i]))

    ths = [threading.Thread(target=loop, args=(i,)) for i in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(300)
    assert not any(t.is_alive() for t in ths)
    assert wrong == [0] * 4


@pytest.fixture(scope="module")
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs: torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()}")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_launches_run_on_their_tensors_device(two_gpus):
    """Every kernel launched on tensors of cuda:1 while cuda:0 is the
    current device: each wrapper makes the tensors' device current, so
    the launch, its stream and its pointers agree."""
    from sortmerna_tpu_torch.ops import seed_search as S
    dev = two_gpus[1]
    rng = np.random.default_rng(29)
    mat = torch.from_numpy(MAT).to(dev)
    with torch.cuda.device(two_gpus[0]):
        Q, rv, R, cv = (torch.from_numpy(a).to(dev)
                        for a in testing.scan_tiles(rng, 512, 256, 256)[:4])
        for kernel, plain in ((K.sw_scan, K.sw_scan_plain),
                              (K.sw_scan2, K.sw_scan2_plain)):
            _same(kernel(Q, rv, R, cv, mat, 5, 2, False, None),
                  plain(Q, rv, R, cv, mat, 5, 2, False, None))
        buf = torch.from_numpy(testing.fused_block(rng, 512, 256, 256)) \
            .to(dev)
        for kernel, plain in ((K.sw_fused, K.sw_fused_plain),
                              (K.sw_fused2, K.sw_fused2_plain)):
            _same(kernel(buf, mat, 512, 256, 256, 5, 2).cpu()[None],
                  plain(buf.cpu(), mat.cpu(), 512, 256, 256, 5, 2)[None])
        c = testing.probe_edges()[0]
        host = {k: torch.from_numpy(v) for k, v in c["tabs"].items()}
        tabs = S.with_home_bits({k: v.to(dev) for k, v in host.items()})
        w1, w2 = (torch.from_numpy(c[k].astype(np.int32)) for k in ("w1",
                                                                     "w2"))
        count, ids = S.seed_probe(tabs, w1.to(dev), w2.to(dev), c["pw"],
                                  False, c["minoccur"])
        win, got, total = S.seed_compact(count, ids, c["pw"])
        n = int(total[0])
        want = S.probe_windows_plain(host, w1.long(), w2.long(), c["pw"],
                                     False, c["minoccur"])
        _same((win[:n], got[:n]), want)
        # a wave through the backend of cuda:1: its event and copies too
        jobs = _wave_jobs(rng, 300)
        got = TorchSwBackend(MAT, 5, 2, device=dev).batch_coords(*jobs)
    want = TorchSwBackend(MAT, 5, 2, device="cpu").batch_coords(*jobs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("layout", ["one_gpu_twice", "two_gpus"])
def test_mesh_backend_matches_cpu(cuda, request, layout):
    """MeshSwBackend splits each wave block into a slice a device, each
    fused by sw_fused on its device: the same arrays as the cpu backend,
    on [cuda:0, cuda:0] (any card) and [cuda:0, cuda:1]."""
    from sortmerna_tpu_torch.parallel.dist import MeshSwBackend
    from sortmerna_tpu_torch.parallel.mesh import sharded_sw_step
    devices = [cuda, cuda] if layout == "one_gpu_twice" \
        else request.getfixturevalue("two_gpus")
    rng = np.random.default_rng(31)
    jobs = _wave_jobs(rng, 701)
    K.reset_launches()
    got = MeshSwBackend(MAT, 5, 2, devices).batch_coords(*jobs)
    assert K.LAUNCHES["sw_fused"] == 2     # one block, a slice a device
    want = TorchSwBackend(MAT, 5, 2, device="cpu").batch_coords(*jobs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    Q, _, R, _, qlen, rlen = testing.scan_tiles(rng, 203, 128, 192)
    minimal = rng.integers(0, 40, 203).astype(np.int32)
    K.reset_launches()
    got = sharded_sw_step(Q, qlen, R, rlen, MAT, minimal, 5, 2, devices)
    assert K.LAUNCHES["sw_scan"] == 2
    want = sharded_sw_step(Q, qlen, R, rlen, MAT, minimal, 5, 2, ["cpu"])
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]
