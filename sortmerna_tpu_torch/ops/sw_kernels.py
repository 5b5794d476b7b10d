"""The SW column-scan kernels: wrappers, plain PyTorch versions, build.

Two entries share one hand-written CUDA routine (csrc/sw_scan.cu):

* ``sw_scan`` -- the column scan over padded tiles with explicit row and
  column masks, ``(Q, row_valid, R, col_valid, mat, go, ge, terminate,
  tscore) -> (best, end_ref, end_read)``.  It replaces the JAX package's
  Pallas kernel ``sortmerna_tpu/ops/sw_pallas.py::_scan_kernel`` and its
  XLA twin ``ops/sw_jax.py::_sw_scan``.
* ``sw_fused`` -- one SW wave block in one launch: uint8
  ``[B, lq/2+lr/2+12]`` -> int32 ``[5, B]`` (score, beg_ref, end_ref,
  beg_read, end_read); the counterpart of ``ops/sw_jax.py::sw_fused_call``.

Semantics (ssw.c tie-breaking): for each ref column ``sub`` is the
substitution score (NEG where the row or the column is invalid),
``diag = shift(Hprev) + sub``, ``E = max(E-ge, Hprev-go)``,
``Hpre = max(0, diag, E)``, F is the closed-form in-column gap run (the
inclusive prefix max of ``Hpre-go+row*ge`` shifted down one row, minus
``(row-1)*ge``), ``H = max(Hpre, F)`` masked by the row mask.  The best
score updates on a strict ``>`` in valid, not-done columns (earliest
column wins), at the smallest row of the column max; in terminate mode a
pair is done once its column max equals ``tscore``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises -- it never falls back.  Each launch adds
one to ``LAUNCHES[name]``.  The kernels build with ``nvcc`` for
``sm_90a`` at first use into ``build/torch_kernels/libsmr_sw.so`` and are
bound with ctypes (plain C interface).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

NEG = -(1 << 30)

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sw_scan.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libsmr_sw.so"
# nvcc's output of the last build, with ptxas's register / spill report
BUILD_LOG = BUILD_DIR / "libsmr_sw.log"

# launches of each kernel since the last reset (plain-version calls on CPU
# tensors do not count)
LAUNCHES = {"sw_scan": 0, "sw_fused": 0}
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build + load


def _nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "sortmerna_tpu_torch: nvcc not found (set NVCC or CUDA_HOME); the "
        "SW kernels cannot be built for a CUDA device")


def build(force: bool = False) -> pathlib.Path:
    """Compile csrc/sw_scan.cu for sm_90a (if the library is missing or
    older than its source) to a temp name, then rename it atomically."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(".so.%d" % os.getpid())
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("sortmerna_tpu_torch: nvcc failed building "
                           f"{SOURCE.name}:\n{proc.stderr[-4000:]}")
    BUILD_LOG.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()), mode=ctypes.RTLD_LOCAL)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.smr_sw_scratch_ints.restype = ctypes.c_longlong
            lib.smr_sw_scratch_ints.argtypes = [ci, ci]
            lib.smr_sw_scan.restype = ci
            lib.smr_sw_scan.argtypes = ([vp] * 5 + [ci] * 3 + [vp]
                                        + [ci] * 3 + [vp] * 3)
            lib.smr_sw_fused.restype = ci
            lib.smr_sw_fused.argtypes = [vp, vp] + [ci] * 5 + [vp] * 3
            _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)


def sw_scan_plain(Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
                  terminate, tscore):
    """Line-by-line twin of sortmerna_tpu/ops/sw_jax.py::_sw_scan."""
    B, Lq = Q.shape
    Lr = R.shape[1]
    dev = Q.device
    i32 = torch.int32
    rows = torch.arange(Lq, dtype=i32, device=dev)
    mat = mat.to(device=dev, dtype=i32)

    prof = mat.t()[Q.long().clamp(0, 4)]                  # [B, Lq, 5]
    prof = torch.where(row_valid[:, :, None], prof,
                       torch.tensor(NEG, dtype=i32, device=dev))
    # the where-chain over ref chars (0..3, anything else reads p4) as one
    # gather per column: prof5[b, c] is pair b's profile row for char c
    prof5 = prof.permute(0, 2, 1).contiguous()            # [B, 5, Lq]
    rcode = torch.where((R >= 0) & (R < 4), R, 4).long()
    bidx = torch.arange(B, device=dev)

    s = max((Lq - 1).bit_length(), 1)
    packed = (Lq << s) < (1 << 24)
    revrow = (Lq - 1 - rows)[None, :]
    f_ofs = (rows * gap_ext)[None, :]
    f_sub = ((rows - 1) * gap_ext)[None, :]
    if tscore is None:
        tscore = torch.zeros(B, dtype=i32, device=dev)
    tscore = tscore.to(i32)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=i32, device=dev)

    last_valid = (Lq - 1 - torch.argmax(
        torch.flip(row_valid, [1]).to(i32), dim=1).to(i32))
    Hprev = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.full((B, Lq), NEG, dtype=i32, device=dev)
    bestscore = torch.zeros(B, dtype=i32, device=dev)
    bestkey = (Lq - 1 - last_valid).to(i32)
    end_ref = torch.full((B,), -1, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    CT = col_valid.t()
    # Columns where no pair is valid change no output: past the last one
    # the scan stops, and before the first one H stays 0 (E becomes -go,
    # and a valid column's E is -go from either start), so with gap
    # penalties >= 0 the scan starts there.
    live = torch.nonzero(col_valid.any(0)).flatten().tolist()
    j0 = live[0] if live and gap_open >= 0 and gap_ext >= 0 else 0
    j1 = live[-1] + 1 if live else 0
    for j in range(j0, j1):
        cvj = CT[j]
        sub = prof5[bidx, rcode[:, j]]
        sub = torch.where(cvj[:, None], sub, NEG)
        diag = torch.cat([zcol, Hprev[:, :-1]], dim=1) + sub
        E = torch.maximum(E - gap_ext, Hprev - gap_open)
        Hpre = torch.clamp(torch.maximum(diag, E), min=0)
        g = Hpre - gap_open + f_ofs
        gmax = torch.cummax(g, dim=1).values
        F = torch.cat([ncol, gmax[:, :-1]], dim=1) - f_sub
        H = torch.maximum(Hpre, F)
        H = torch.where(row_valid, H, 0)

        if packed:
            key = (H << s) | revrow
            colkey = key.max(dim=1).values
            colmax = colkey >> s
        else:
            colmax = H.max(dim=1).values
            colrow = torch.where(H == colmax[:, None], revrow, -1) \
                .max(dim=1).values
            colkey = colrow
        valid = cvj & ~done
        improved = (colmax > bestscore) & valid
        bestscore = torch.where(improved, colmax, bestscore)
        bestkey = torch.where(improved, colkey, bestkey)
        end_ref = torch.where(improved, j, end_ref)
        if terminate:
            done = done | ((colmax == tscore) & valid)
        Hprev = H
    if packed:
        end_read = Lq - 1 - (bestkey & ((1 << s) - 1))
    else:
        end_read = Lq - 1 - bestkey
    return bestscore, end_ref, end_read.to(i32)


def _unpack_buf(buf, lq: int, lr: int):
    hq, hr = lq // 2, lr // 2

    def unpack(p):            # [B, L/2] packed -> [B, L] chars
        hi = (p >> 4) & 0xF
        lo = p & 0xF
        return torch.stack([hi, lo], dim=2).reshape(p.shape[0], -1)

    Q = unpack(buf[:, :hq].to(torch.int32))
    R = unpack(buf[:, hq:hq + hr].to(torch.int32))
    ints = buf[:, hq + hr:].to(torch.int32)

    def i32(k):
        b = ints[:, 4 * k:4 * k + 4]
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    return Q, R, i32(0), i32(1), i32(2)


def sw_fused_plain(buf, mat, B: int, lq: int, lr: int, gap_open: int,
                   gap_ext: int):
    """Twin of sortmerna_tpu/ops/sw_jax.py::sw_fused_call: the begin pass
    runs on FLIPPED tiles with per-pair start masks."""
    Q, R, q_len, r_len, minimal = _unpack_buf(buf, lq, lr)
    dev = buf.device
    posq = torch.arange(lq, dtype=torch.int32, device=dev)[None, :]
    posr = torch.arange(lr, dtype=torch.int32, device=dev)[None, :]
    row_valid = posq < q_len[:, None]
    col_valid = posr < r_len[:, None]
    score, end_ref, end_read = sw_scan_plain(
        Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
        terminate=False, tscore=None)
    end_read = torch.where(end_ref >= 0, end_read, q_len - 1)

    Qf = torch.flip(Q, [1])
    Rf = torch.flip(R, [1])
    q_start = lq - 1 - end_read
    r_start = lr - 1 - end_ref
    row_valid2 = posq >= q_start[:, None]
    col_valid2 = posr >= r_start[:, None]
    s2, jstar, istar = sw_scan_plain(
        Qf, row_valid2, Rf, col_valid2, mat, gap_open, gap_ext,
        terminate=True, tscore=score)
    ok = (score >= minimal) & (end_ref >= 0)
    beg_ref = torch.where(ok, lr - 1 - jstar, -1)
    beg_read = torch.where(ok, lq - 1 - istar, -1)
    return torch.stack([score, beg_ref, end_ref, beg_read,
                        end_read]).to(torch.int32)


def sw_score_batch_plain(query, qlen, ref, rlen, mat, gap_open: int,
                         gap_ext: int, terminate: bool = False,
                         tscore=None):
    """Twin of sortmerna_tpu/ops/sw_jax.py::sw_score_batch."""
    B, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    i32 = torch.int32
    rows = torch.arange(Lq, dtype=i32, device=dev)
    qlen = qlen.to(i32)
    rlen = rlen.to(i32)
    qmask = rows[None, :] < qlen[:, None]
    mat = mat.to(device=dev, dtype=i32)
    prof = mat.t()[query.long().clamp(0, 4)]             # [B, Lq, 5]
    prof = torch.where(qmask[:, :, None], prof,
                       torch.tensor(NEG, dtype=i32, device=dev))
    if tscore is None:
        tscore = torch.zeros(B, dtype=i32, device=dev)
    tscore = tscore.to(i32)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=i32, device=dev)

    Hprev = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.full((B, Lq), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    end_ref = torch.full((B,), -1, dtype=i32, device=dev)
    end_read = qlen - 1
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ridx = ref.long().clamp(0, 4)
    # columns past every pair's rlen change no output
    for j in range(min(Lr, int(rlen.max()) if B else 0)):
        rj = ridx[:, j]
        sub = torch.gather(prof, 2,
                           rj[:, None, None].expand(B, Lq, 1))[:, :, 0]
        diag = torch.cat([zcol, Hprev[:, :-1]], dim=1) + sub
        E = torch.maximum(E - gap_ext, Hprev - gap_open)
        Hpre = torch.clamp(torch.maximum(diag, E), min=0)
        g = Hpre - gap_open + rows[None, :] * gap_ext
        gmax = torch.cummax(g, dim=1).values
        F = torch.cat([ncol, gmax[:, :-1]], dim=1) \
            - (rows[None, :] - 1) * gap_ext
        H = torch.maximum(Hpre, F)
        H = torch.where(qmask, H, 0)

        colmax = H.max(dim=1).values
        valid = (j < rlen) & ~done
        improved = (colmax > best) & valid
        row = torch.argmax((H == colmax[:, None]).to(i32), dim=1).to(i32)
        best = torch.where(improved, colmax, best)
        end_ref = torch.where(improved, j, end_ref)
        end_read = torch.where(improved, row, end_read)
        if terminate:
            done = done | ((colmax == tscore) & valid)
        Hprev = H
    return best, end_ref, end_read


# ---------------------------------------------------------------------------
# wrappers


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_device(t, name) -> torch.device:
    if t.device.type == "cpu":
        return t.device
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the SW kernels run on "
                         "cuda (or their plain versions on cpu)")
    return t.device


def _scratch(lib, B: int, L: int, device):
    n = int(lib.smr_sw_scratch_ints(B, L))
    return torch.empty(n, dtype=torch.int32, device=device) if n else None


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"sortmerna_tpu_torch: {name} launch failed "
                           f"(cudaError_t {err})")


def sw_scan(Q, row_valid, R, col_valid, mat, gap_open: int, gap_ext: int,
            terminate: bool, tscore=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column scan over padded tiles: (best, end_ref, end_read), int32
    [B] each.  Q, R int32 [B, Lq] / [B, Lr] (chars 0..4), row_valid /
    col_valid bool, mat int32 [5, 5], tscore int32 [B] or None."""
    device = _on_device(Q, "Q")
    if device.type == "cpu":
        return sw_scan_plain(Q, row_valid, R, col_valid, mat, gap_open,
                             gap_ext, terminate, tscore)
    B, Lq = Q.shape
    Lr = R.shape[1]
    _check(Q, "Q", torch.int32, (B, Lq), device)
    _check(row_valid, "row_valid", torch.bool, (B, Lq), device)
    _check(R, "R", torch.int32, (B, Lr), device)
    _check(col_valid, "col_valid", torch.bool, (B, Lr), device)
    _check(mat, "mat", torch.int32, (5, 5), device)
    if tscore is not None:
        _check(tscore, "tscore", torch.int32, (B,), device)
    lib = load()
    out = torch.empty((3, B), dtype=torch.int32, device=device)
    scratch = _scratch(lib, B, Lq, device)
    err = lib.smr_sw_scan(
        Q.data_ptr(), row_valid.view(torch.uint8).data_ptr(), R.data_ptr(),
        col_valid.view(torch.uint8).data_ptr(), mat.data_ptr(),
        int(gap_open), int(gap_ext), int(bool(terminate)),
        tscore.data_ptr() if tscore is not None else None,
        B, Lq, Lr, out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "sw_scan")
    LAUNCHES["sw_scan"] += 1
    return out[0], out[1], out[2]


def sw_fused(buf, mat, B: int, lq: int, lr: int, gap_open: int,
             gap_ext: int) -> torch.Tensor:
    """One SW wave block: uint8 [B, lq/2+lr/2+12] -> int32 [5, B]
    (score, beg_ref, end_ref, beg_read, end_read)."""
    device = _on_device(buf, "buf")
    if device.type == "cpu":
        return sw_fused_plain(buf, mat, B, lq, lr, gap_open, gap_ext)
    if lq % 2 or lr % 2:
        raise ValueError(f"lq={lq}, lr={lr} must be even (packed nibbles)")
    _check(buf, "buf", torch.uint8, (B, lq // 2 + lr // 2 + 12), device)
    _check(mat, "mat", torch.int32, (5, 5), device)
    lib = load()
    out = torch.empty((5, B), dtype=torch.int32, device=device)
    scratch = _scratch(lib, B, lq, device)
    err = lib.smr_sw_fused(
        buf.data_ptr(), mat.data_ptr(), B, lq, lr, int(gap_open),
        int(gap_ext), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "sw_fused")
    LAUNCHES["sw_fused"] += 1
    return out


def sw_score_batch(query, qlen, ref, rlen, mat, gap_open: int,
                   gap_ext: int, terminate: bool = False, tscore=None):
    """sw_jax.sw_score_batch contract (masks built from qlen / rlen): the
    plain twin on CPU tensors, the sw_scan kernel on CUDA tensors."""
    device = _on_device(query, "query")
    if device.type == "cpu":
        return sw_score_batch_plain(query, qlen, ref, rlen, mat, gap_open,
                                    gap_ext, terminate, tscore)
    Lq, Lr = query.shape[1], ref.shape[1]
    qlen = qlen.to(torch.int32)
    row_valid = torch.arange(Lq, device=device)[None, :] < qlen[:, None]
    col_valid = torch.arange(Lr, device=device)[None, :] \
        < rlen.to(torch.int32)[:, None]
    best, end_ref, end_read = sw_scan(
        query.contiguous(), row_valid, ref.contiguous(), col_valid, mat,
        gap_open, gap_ext, terminate, tscore)
    # sw_score_batch starts end_read at qlen-1 (the scan at the last
    # valid row): the two differ only where nothing scored
    return best, end_ref, torch.where(end_ref >= 0, end_read, qlen - 1)
