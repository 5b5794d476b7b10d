"""The SW column-scan kernels: wrappers, plain PyTorch versions, build.

Two hand-written CUDA sources, each with two entries, on one DP core
(``csrc/sw_wave.cuh``: a warp per pair, an anti-diagonal wavefront across
the lanes, rows fitted to each pair, DPX arithmetic; tiles of more than
1,024 query rows cut a pair's rows into stripes over the warps of
a CTA or of a thread-block cluster, whose hand-off ``stripe_scan_plain``
writes out plainly); each source brings its own column reads and NEG:

* csrc/sw_scan.cu, the port of the JAX package's Pallas kernel
  ``sortmerna_tpu/ops/sw_pallas.py::_scan_kernel`` (the default path):

  - ``sw_scan`` -- the column scan over padded tiles with explicit row and
    column masks, ``(Q, row_valid, R, col_valid, mat, go, ge, terminate,
    tscore) -> (best, end_ref, end_read)``; it also stands for the XLA
    twin ``ops/sw_jax.py::_sw_scan``, and, with its gather flag set, for
    ``sw_jax.sw_score_batch``;
  - ``sw_fused`` -- one SW wave block in one launch: uint8
    ``[B, lq/2+lr/2+12]`` -> int32 ``[5, B]`` (score, beg_ref, end_ref,
    beg_read, end_read); the counterpart of ``ops/sw_jax.py::sw_fused_call``.

* csrc/sw_scan2.cu, the port of the batch-major Pallas kernel
  ``_scan_kernel2`` (``SMR_PALLAS=2``):

  - ``sw_scan2`` -- the ``sw_scan_pallas2`` contract; ``B`` must be a
    multiple of 512, as there;
  - ``sw_fused2`` -- the ``sw_fused`` contract with v2 dispatched inside
    ``sw_fused_call``; it takes any ``B``.

Semantics (ssw.c tie-breaking): for each ref column ``sub`` is the
substitution score (NEG where the row or the column is invalid),
``diag = shift(Hprev) + sub``, ``E = max(E-ge, Hprev-go)``,
``Hpre = max(0, diag, E)``, F is the closed-form in-column gap run (the
inclusive prefix max of ``Hpre-go+row*ge`` shifted down one row, minus
``(row-1)*ge``), ``H = max(Hpre, F)`` masked by the row mask.  The best
score updates on a strict ``>`` in valid, not-done columns (earliest
column wins), at the smallest row of the column max; in terminate mode a
pair is done once its column max equals ``tscore``.  A query char reads
the profile row that the JAX package's ``mat.T[Q]`` gather gives (a
negative index wraps once, then clamps to 0..4: ``_profile_rows``).  v2
reads its columns differently on odd inputs (see ``_v2_columns``), and
``sw_score_batch`` reads them by ``take_along_axis`` (see its plain twin).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises -- it never falls back.  Each launch adds
one to ``LAUNCHES[name]``.  ``build()`` compiles every ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<stem>.so`` (one
nvcc per source, run in parallel; a library is rebuilt when its source or
any ``csrc/*.cuh`` is newer); ``load_library`` loads one at first use and
binds it with ctypes (plain C interface).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import torch

NEG = -(1 << 30)
NEG2 = -(1 << 29)          # the v2 kernel's NEG (sortmerna_tpu/ops/sw_pallas.py)
SUB_B = 512                # pairs per grid step of the TPU v2 kernel
MAX_ROWS = 65536           # the widest tile the kernels take (csrc MAX_ROWS)

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# launches of each kernel since the last reset (plain-version calls on CPU
# tensors do not count)
LAUNCHES = {"sw_scan": 0, "sw_fused": 0, "sw_scan2": 0, "sw_fused2": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SCAN_ARGS = [_VP] * 5 + [_CI] * 3 + [_VP] + [_CI] * 3 + [_VP] * 2
_FUSED_ARGS = [_VP, _VP] + [_CI] * 5 + [_VP] * 2
# the C entries of each library: name -> (restype, argtypes)
SIGNATURES = {
    "sw_scan": {
        "smr_sw_long_geometry": (None, [_CI, _VP, _VP]),
        "smr_sw_scan": (_CI, _SCAN_ARGS + [_CI]),     # + gather
        "smr_sw_fused": (_CI, _FUSED_ARGS),
    },
    "sw_scan2": {
        "smr_sw_scan2": (_CI, _SCAN_ARGS),
        "smr_sw_fused2": (_CI, _FUSED_ARGS),
    },
}


_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str, counts=LAUNCHES) -> None:
    """One more launch of kernel ``name`` (wrappers run in several threads
    under read shards, and a ctypes call releases the GIL)."""
    with _COUNT_LOCK:
        counts[name] += 1


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
        "kernels cannot be built for a CUDA device")


def library_path(stem: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{stem}.so"


def build_log(stem: str) -> pathlib.Path:
    """nvcc's output of the last build of ``csrc/<stem>.cu``, with ptxas's
    register / spill report."""
    return BUILD_DIR / f"lib{stem}.log"


def build_one(stem: str, force: bool = False) -> pathlib.Path:
    """Compile csrc/<stem>.cu for sm_90a (if the library is missing or
    older than its source or a csrc/*.cuh header) to a temp name, then
    rename it atomically."""
    src, lib = CSRC / f"{stem}.cu", library_path(stem)
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.%d" % os.getpid())
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("sortmerna_tpu_torch: nvcc failed building "
                           f"{src.name}:\n{proc.stderr[-4000:]}")
    build_log(stem).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> Dict[str, pathlib.Path]:
    """Compile every csrc/*.cu, one nvcc per source, all at once."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(stems)) as ex:
        libs = list(ex.map(lambda s: build_one(s, force), stems))
    return dict(zip(stems, libs))


def load_library(stem: str, signatures=None) -> ctypes.CDLL:
    """The kernel library of csrc/<stem>.cu, built on first use, with the
    ctypes signatures of its C entries bound."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_one(stem)), mode=ctypes.RTLD_LOCAL)
            sigs = SIGNATURES[stem] if signatures is None else signatures
            for name, (res, args) in sigs.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIBS[stem] = lib
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)


def sw_scan_plain(Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
                  terminate, tscore):
    """Line-by-line twin of sortmerna_tpu/ops/sw_jax.py::_sw_scan."""
    # the where-chain over ref chars: 0..3, anything else reads p4
    rcode = torch.where((R >= 0) & (R < 4), R, 4)
    return _column_scan(Q, row_valid, rcode, col_valid, mat, gap_open,
                        gap_ext, terminate, tscore, NEG)


def _profile_rows(Q):
    """The profile row that ``mat.T[Q]`` reads in the JAX package: a
    negative index wraps once (-1 reads row 4), then it clamps to 0..4."""
    Q = Q.long()
    return torch.where(Q < 0, Q + 5, Q).clamp(0, 4)


def _v2_columns(R, col_valid):
    """How _scan_kernel2 reads its ref columns (sw_pallas.py:206-218):
    ``R_enc = where(col_valid, R, 7)``; column j comes out of its
    128-column chunk by a masked max against 0, and a last chunk that
    runs past Lr is read from Lr - 128 on (its dynamic slice is clamped);
    the column is valid iff that char is < 5, and the select chain falls
    through to profile 0.  Returns (char 0..4, valid)."""
    Lr = R.shape[1]
    renc = torch.where(col_valid, R, 7)
    if Lr >= 128:
        j = torch.arange(Lr, device=R.device)
        jc = j // 128 * 128
        renc = renc[:, torch.clamp(jc, max=Lr - 128) + (j - jc)]
    rj = renc.clamp(min=0)
    valid = rj < 5
    return torch.where(valid, rj, 0), valid


def _scan2(Q, row_valid, R, col_valid, mat, gap_open, gap_ext, terminate,
           tscore):
    """v2's scan for any B (the per-pair function of sw_scan_pallas2)."""
    rcode, cvalid = _v2_columns(R, col_valid)
    return _column_scan(Q, row_valid, rcode, cvalid, mat, gap_open,
                        gap_ext, terminate, tscore, NEG2)


def sw_scan2_plain(Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
                   terminate, tscore):
    """Twin of sortmerna_tpu/ops/sw_pallas.py::sw_scan_pallas2."""
    if Q.shape[0] % SUB_B:
        raise ValueError(f"B={Q.shape[0]} must be a multiple of {SUB_B}")
    return _scan2(Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
                  terminate, tscore)


def _column_scan(Q, row_valid, rcode, col_valid, mat, gap_open, gap_ext,
                 terminate, tscore, neg):
    """The column scan of both kernels, given each column's char (0..4
    where valid) and validity; ``neg`` is the kernel's NEG."""
    B, Lq = Q.shape
    dev = Q.device
    i32 = torch.int32
    rows = torch.arange(Lq, dtype=i32, device=dev)
    mat = mat.to(device=dev, dtype=i32)

    prof = mat.t()[_profile_rows(Q)]                      # [B, Lq, 5]
    prof = torch.where(row_valid[:, :, None], prof,
                       torch.tensor(neg, dtype=i32, device=dev))
    # the where-chain over ref chars as one gather per column: prof5[b, c]
    # is pair b's profile row for char c
    prof5 = prof.permute(0, 2, 1).contiguous()            # [B, 5, Lq]
    rcode = rcode.long()
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
    ncol = torch.full((B, 1), neg, dtype=i32, device=dev)

    last_valid = (Lq - 1 - torch.argmax(
        torch.flip(row_valid, [1]).to(i32), dim=1).to(i32))
    Hprev = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.full((B, Lq), neg, dtype=i32, device=dev)
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
        sub = torch.where(cvj[:, None], sub, neg)
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


def stripe_scan_plain(Q, row_valid, R, col_valid, mat, gap_open,
                      gap_ext, terminate, tscore, height: int,
                      version: int = 1):
    """The long-tile kernels' decomposition of the column scan, written
    plainly (used by the tests only): the rows in stripes of ``height``,
    each run over every column before the next, consuming the stripe
    above's bottom-row H, F carry and 64-bit column key ((H << 32) +
    Lq - 1 - row) per column; only the last stripe applies improved /
    terminate.  ``version`` 1 reads the columns as sw_scan does, 2 as
    sw_scan2 (any B).  Equals sw_scan_plain / _scan2 bit for bit."""
    if version == 1:
        rcode = torch.where((R >= 0) & (R < 4), R, 4)
        return _stripe_scan(Q, row_valid, rcode, col_valid, mat, gap_open,
                            gap_ext, terminate, tscore, NEG, height)
    rcode, cvalid = _v2_columns(R, col_valid)
    return _stripe_scan(Q, row_valid, rcode, cvalid, mat, gap_open,
                        gap_ext, terminate, tscore, NEG2, height)


def stripe_fused_plain(buf, mat, B: int, lq: int, lr: int, gap_open: int,
                       gap_ext: int, height: int, version: int = 1):
    """sw_fused_plain (version 1) or sw_fused2_plain (2) with both passes
    through stripe_scan_plain at ``height`` rows a stripe."""
    def scan(*a, terminate, tscore):
        return stripe_scan_plain(*a, terminate, tscore, height, version)
    return _fused(buf, mat, lq, lr, gap_open, gap_ext, scan)


def _stripe_scan(Q, row_valid, rcode, col_valid, mat, gap_open, gap_ext,
                 terminate, tscore, neg, height):
    B, Lq = Q.shape
    dev = Q.device
    i32, i64 = torch.int32, torch.int64
    mat = mat.to(device=dev, dtype=i32)
    prof = mat.t()[_profile_rows(Q)]                      # [B, Lq, 5]
    prof = torch.where(row_valid[:, :, None], prof,
                       torch.tensor(neg, dtype=i32, device=dev))
    prof5 = prof.permute(0, 2, 1).contiguous()            # [B, 5, Lq]
    rcode = rcode.long()
    bidx = torch.arange(B, device=dev)
    if tscore is None:
        tscore = torch.zeros(B, dtype=i32, device=dev)
    tscore = tscore.to(i32)
    last_valid = (Lq - 1 - torch.argmax(
        torch.flip(row_valid, [1]).to(i32), dim=1).to(i32))
    bestscore = torch.zeros(B, dtype=i32, device=dev)
    bestkey = (Lq - 1 - last_valid).to(i64)
    end_ref = torch.full((B,), -1, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    CT = col_valid.t()
    live = torch.nonzero(col_valid.any(0)).flatten().tolist()
    j0 = live[0] if live and gap_open >= 0 and gap_ext >= 0 else 0
    j1 = live[-1] + 1 if live else 0
    ncol = rcode.shape[1]
    # the boundary above the first stripe, per column: H 0, the F carry
    # NEG - (0 - 1) * ge of the closed form's row 0, key 0
    bh = torch.zeros((B, ncol), dtype=i32, device=dev)
    bf = torch.full((B, ncol), neg + gap_ext, dtype=i32, device=dev)
    bk = torch.zeros((B, ncol), dtype=i64, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    for r0 in range(0, Lq, height):
        r1 = min(r0 + height, Lq)
        n = r1 - r0
        rows = torch.arange(n, dtype=i32, device=dev)[None, :]
        revrow = (Lq - 1 - r0 - rows).to(i64)
        valid = row_valid[:, r0:r1]
        last = r1 == Lq
        Hprev = torch.zeros((B, n), dtype=i32, device=dev)
        E = torch.full((B, n), neg, dtype=i32, device=dev)
        oh, of, ok = bh.clone(), bf.clone(), bk.clone()
        for j in range(j0, j1):
            cvj = CT[j]
            sub = prof5[bidx, rcode[:, j], r0:r1]
            sub = torch.where(cvj[:, None], sub, neg)
            # the diagonal into the stripe's first row: the stripe above's
            # bottom H at the previous column (0 before the first)
            top = bh[:, j - 1:j] if j > j0 else zcol
            diag = torch.cat([top, Hprev[:, :-1]], dim=1) + sub
            E = torch.maximum(E - gap_ext, Hprev - gap_open)
            Hpre = torch.clamp(torch.maximum(diag, E), min=0)
            # F: the carry from above, falling one ge a row, against the
            # closed form inside the stripe
            fin = bf[:, j:j + 1]
            gmax = torch.cummax(Hpre - gap_open + rows * gap_ext,
                                dim=1).values
            F = torch.maximum(
                torch.cat([fin - gap_ext, gmax[:, :-1]], dim=1)
                - (rows - 1) * gap_ext,
                fin - rows * gap_ext)
            H = torch.maximum(Hpre, F)
            H = torch.where(valid, H, 0)
            colkey = torch.maximum(
                ((H.to(i64) << 32) + revrow).max(dim=1).values, bk[:, j])
            oh[:, j] = H[:, -1]
            of[:, j] = torch.maximum(fin[:, 0] - n * gap_ext,
                                     gmax[:, -1] - (n - 1) * gap_ext)
            ok[:, j] = colkey
            if last:
                colmax = (colkey >> 32).to(i32)
                ok_col = cvj & ~done
                improved = (colmax > bestscore) & ok_col
                bestscore = torch.where(improved, colmax, bestscore)
                bestkey = torch.where(improved, colkey, bestkey)
                end_ref = torch.where(improved, j, end_ref)
                if terminate:
                    done = done | ((colmax == tscore) & ok_col)
            Hprev = H
        bh, bf, bk = oh, of, ok
    end_read = Lq - 1 - (bestkey & 0xFFFFFFFF)
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
    return _fused(buf, mat, lq, lr, gap_open, gap_ext, sw_scan_plain)


def sw_fused2_plain(buf, mat, B: int, lq: int, lr: int, gap_open: int,
                    gap_ext: int):
    """Twin of sw_fused_call with SMR_PALLAS=2 (both passes through
    sw_scan_pallas2's function), for any B."""
    return _fused(buf, mat, lq, lr, gap_open, gap_ext, _scan2)


def _fused(buf, mat, lq: int, lr: int, gap_open: int, gap_ext: int, scan):
    Q, R, q_len, r_len, minimal = _unpack_buf(buf, lq, lr)
    dev = buf.device
    posq = torch.arange(lq, dtype=torch.int32, device=dev)[None, :]
    posr = torch.arange(lr, dtype=torch.int32, device=dev)[None, :]
    row_valid = posq < q_len[:, None]
    col_valid = posr < r_len[:, None]
    score, end_ref, end_read = scan(
        Q, row_valid, R, col_valid, mat, gap_open, gap_ext,
        terminate=False, tscore=None)
    end_read = torch.where(end_ref >= 0, end_read, q_len - 1)

    Qf = torch.flip(Q, [1])
    Rf = torch.flip(R, [1])
    q_start = lq - 1 - end_read
    r_start = lr - 1 - end_ref
    row_valid2 = posq >= q_start[:, None]
    col_valid2 = posr >= r_start[:, None]
    s2, jstar, istar = scan(
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
    prof = mat.t()[_profile_rows(query)]                 # [B, Lq, 5]
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
    # the ref char's profile by take_along_axis: -5..-1 wrap, and any
    # code still outside 0..4 reads its fill value, INT32_MIN
    ridx = ref.long()
    ridx = torch.where(ridx < 0, ridx + 5, ridx)
    fill = (ridx < 0) | (ridx > 4)
    ridx = ridx.clamp(0, 4)
    # columns past every pair's rlen change no output
    for j in range(min(Lr, int(rlen.max()) if B else 0)):
        rj = ridx[:, j]
        sub = torch.gather(prof, 2,
                           rj[:, None, None].expand(B, Lq, 1))[:, :, 0]
        sub = torch.where(fill[:, j, None], torch.iinfo(i32).min, sub)
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
        raise ValueError(f"{name} is on {t.device}; the kernels run on "
                         "cuda (or their plain versions on cpu)")
    return t.device


# each kernel version's library and C entries: (stem, scan, fused)
_ENTRIES = {1: ("sw_scan", "smr_sw_scan", "smr_sw_fused"),
            2: ("sw_scan2", "smr_sw_scan2", "smr_sw_fused2")}


def long_geometry(L: int) -> Tuple[int, int]:
    """(warps a CTA, CTAs a cluster) of the long-tile route's launch for a
    tile of L query rows, as the C entries choose it (both sources share
    it); (0, 0) for a tile on the register path (L <= 1,024)."""
    lib = load_library("sw_scan")
    warps, cluster = ctypes.c_int(), ctypes.c_int()
    lib.smr_sw_long_geometry(int(L), ctypes.byref(warps),
                             ctypes.byref(cluster))
    return warps.value, cluster.value


def _check_rows(L: int) -> None:
    if L > MAX_ROWS:
        raise ValueError(f"a tile of {L} query rows is past the kernels' "
                         f"{MAX_ROWS} (8 CTAs x 16 warps x 512 rows)")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"sortmerna_tpu_torch: {name} launch failed "
                           f"(cudaError_t {err})")


def _launch_scan(version: int, name: str, Q, row_valid, R, col_valid, mat,
                 gap_open, gap_ext, terminate, tscore, device, *tail):
    B, Lq = Q.shape
    Lr = R.shape[1]
    _check(Q, "Q", torch.int32, (B, Lq), device)
    _check(row_valid, "row_valid", torch.bool, (B, Lq), device)
    _check(R, "R", torch.int32, (B, Lr), device)
    _check(col_valid, "col_valid", torch.bool, (B, Lr), device)
    _check(mat, "mat", torch.int32, (5, 5), device)
    if tscore is not None:
        _check(tscore, "tscore", torch.int32, (B,), device)
    _check_rows(Lq)
    stem, scan_fn, _ = _ENTRIES[version]
    lib = load_library(stem)
    # the tensors' device is the current one: the launch runs in its
    # context, on its stream
    with torch.cuda.device(device):
        out = torch.empty((3, B), dtype=torch.int32, device=device)
        err = getattr(lib, scan_fn)(
            Q.data_ptr(), row_valid.view(torch.uint8).data_ptr(),
            R.data_ptr(), col_valid.view(torch.uint8).data_ptr(),
            mat.data_ptr(), int(gap_open), int(gap_ext),
            int(bool(terminate)),
            tscore.data_ptr() if tscore is not None else None,
            B, Lq, Lr, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, *tail)
    _raise_on(err, name)
    count_launch(name)
    return out[0], out[1], out[2]


def _launch_fused(version: int, name: str, buf, mat, B, lq, lr, gap_open,
                  gap_ext, device):
    if lq % 2 or lr % 2:
        raise ValueError(f"lq={lq}, lr={lr} must be even (packed nibbles)")
    _check(buf, "buf", torch.uint8, (B, lq // 2 + lr // 2 + 12), device)
    _check(mat, "mat", torch.int32, (5, 5), device)
    _check_rows(lq)
    stem, _, fused_fn = _ENTRIES[version]
    lib = load_library(stem)
    with torch.cuda.device(device):
        out = torch.empty((5, B), dtype=torch.int32, device=device)
        err = getattr(lib, fused_fn)(
            buf.data_ptr(), mat.data_ptr(), B, lq, lr, int(gap_open),
            int(gap_ext), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, name)
    count_launch(name)
    return out


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
    return _launch_scan(1, "sw_scan", Q, row_valid, R, col_valid, mat,
                        gap_open, gap_ext, terminate, tscore, device, 0)


def sw_scan2(Q, row_valid, R, col_valid, mat, gap_open: int, gap_ext: int,
             terminate: bool, tscore=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sw_scan's contract through the batch-major v2 kernel (the function
    of sw_scan_pallas2); B must be a multiple of 512, as there."""
    device = _on_device(Q, "Q")
    if device.type == "cpu":
        return sw_scan2_plain(Q, row_valid, R, col_valid, mat, gap_open,
                              gap_ext, terminate, tscore)
    if Q.shape[0] % SUB_B:
        raise ValueError(f"B={Q.shape[0]} must be a multiple of {SUB_B}")
    return _launch_scan(2, "sw_scan2", Q, row_valid, R, col_valid, mat,
                        gap_open, gap_ext, terminate, tscore, device)


def sw_fused(buf, mat, B: int, lq: int, lr: int, gap_open: int,
             gap_ext: int) -> torch.Tensor:
    """One SW wave block: uint8 [B, lq/2+lr/2+12] -> int32 [5, B]
    (score, beg_ref, end_ref, beg_read, end_read)."""
    device = _on_device(buf, "buf")
    if device.type == "cpu":
        return sw_fused_plain(buf, mat, B, lq, lr, gap_open, gap_ext)
    return _launch_fused(1, "sw_fused", buf, mat, B, lq, lr, gap_open,
                         gap_ext, device)


def sw_fused2(buf, mat, B: int, lq: int, lr: int, gap_open: int,
              gap_ext: int) -> torch.Tensor:
    """sw_fused's contract through the v2 kernel, for any B (one warp a
    pair: no grid of 512 pairs to fill)."""
    device = _on_device(buf, "buf")
    if device.type == "cpu":
        return sw_fused2_plain(buf, mat, B, lq, lr, gap_open, gap_ext)
    return _launch_fused(2, "sw_fused2", buf, mat, B, lq, lr, gap_open,
                         gap_ext, device)


def sw_score_batch(query, qlen, ref, rlen, mat, gap_open: int,
                   gap_ext: int, terminate: bool = False, tscore=None):
    """sw_jax.sw_score_batch contract (masks built from qlen / rlen): the
    plain twin on CPU tensors, the sw_scan kernel (reading the ref chars
    by take_along_axis) on CUDA tensors."""
    device = _on_device(query, "query")
    if device.type == "cpu":
        return sw_score_batch_plain(query, qlen, ref, rlen, mat, gap_open,
                                    gap_ext, terminate, tscore)
    Lq, Lr = query.shape[1], ref.shape[1]
    qlen = qlen.to(torch.int32)
    row_valid = torch.arange(Lq, device=device)[None, :] < qlen[:, None]
    col_valid = torch.arange(Lr, device=device)[None, :] \
        < rlen.to(torch.int32)[:, None]
    best, end_ref, end_read = _launch_scan(
        1, "sw_scan", query.contiguous(), row_valid, ref.contiguous(),
        col_valid, mat, gap_open, gap_ext, terminate, tscore, device, 1)
    # sw_score_batch starts end_read at qlen-1 (the scan at the last
    # valid row): the two differ only where nothing scored
    return best, end_ref, torch.where(end_ref >= 0, end_read, qlen - 1)
