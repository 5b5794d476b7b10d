"""The CUDA kernels against their plain PyTorch versions, on the card.

Int32-exact, at small shapes that reach both storage paths of the kernel
(rows in registers for Lq <= 1024, in global scratch above).  Every test
is marked ``cuda`` and skips without a GPU.  The JAX package is not
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


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 512, 512),
                                   (16, 2048, 1024)])
def test_sw_fused_kernel_matches_plain(cuda, shape):
    B, lq, lr = shape
    rng = np.random.default_rng(sum(shape))
    buf = torch.from_numpy(testing.fused_block(rng, B, lq, lr)).to(cuda)
    mat = torch.from_numpy(MAT).to(cuda)
    got = K.sw_fused(buf, mat, B, lq, lr, 5, 2)
    torch.cuda.synchronize()
    _same(got, K.sw_fused_plain(buf, mat, B, lq, lr, 5, 2))


def test_backend_on_cuda_matches_cpu(cuda):
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
    assert K.LAUNCHES["sw_fused"] == 1     # 700 jobs fit one block
    want = TorchSwBackend(MAT, 5, 2, device="cpu").batch_coords(*jobs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
