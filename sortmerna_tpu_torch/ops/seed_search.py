"""The device d<=1 window seed search (``--device_probe``).

Port of the JAX package's sortmerna_tpu/ops/seed_search.py (the XLA
device function ``_probe_kernel`` and its ``DeviceSeedSearcher``): for
every read window w = w1.w2 (two packed pw-mers, pw = L/2) the d<=1
accepted reference tails are enumerated in closed form as a static set of
hash probes -- for pw = 9, 1+37+9+36 for subsearch 1a (exact w1) and
1+37+9+36 for subsearch 1b (exact w2) -- against the open-addressing
tables of index/hashtab.py held on the device, then the 0-error mode
selection, the bounded group expansions (F-prefix ranges <= 4, R-exact
<= 4, R-prefix <= 16 members), and the per-window sort and de-dup.

Keys stay 64-bit here (int64 bit patterns of the uint64 keys; the JAX
package split them into 32-bit halves because a TPU has no 64-bit
lanes), and the slot hash is index/hashtab.hash_u64's, bit for bit.

A window batch goes through two kernels of csrc/seed_probe.cu:

* ``seed_probe`` -- a warp per 4 windows (their 0-error lookups a lane
  each, then every other-mode window's probes over all 32 lanes): the
  probes, the expansions, the sort and de-dup; it writes the window's
  count and its sorted ids to a row of scratch.  It reads each table's
  home-slot bitmap (``with_home_bits``, a bit a slot, in L2) before the
  table's keys, so a probe whose home slot is no key's home costs no
  read of the keys;
* ``seed_compact`` -- a thread per window: the offsets (a scan of the
  counts, in the same launch), the (window, id) pairs at them, and the
  total.  The output buffers hold the most a batch can give, so the JAX
  package's cap-retry loop has no counterpart, and the host reads the
  total only when it copies the pairs back.

Their plain versions ``seed_probe_plain`` and ``seed_compact_plain``
together make ``probe_windows_plain``, a line-by-line twin of
``_probe_kernel`` in PyTorch ops (the CPU path, and the yardstick on the
card).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..index.builder import IndexPart
from ..index.hashtab import MAX_PROBES
from . import sw_kernels
from .sw_torch import resolve_device

_M1 = 0x9E3779B1
_M2 = 0x85EBCA77
_MASK32 = 0xFFFFFFFF
M26 = (1 << 26) - 1

# group-size caps (guaranteed by the index layout: an 18-mer group over a
# 17-char prefix has <= 4 members; R exact groups <= 4; R prefix <= 16 --
# index/builder.py finish_part).  Verified against the part when the
# searcher is made.
CAP_FDEL = 4
CAP_RSUB = 4
CAP_RDEL = 16
BIG = 0x7FFFFFFF          # "no id" in the per-window id matrix

LAUNCHES = {"seed_probe": 0, "seed_compact": 0}

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # w1, w2, counts, minoccur, 5 x (keys, vals, home bits, bits), r_ids,
    # n_rids, NW, pw, full_search, out_count, scratch, stream
    "smr_seed_probe": (_CI, [_VP, _VP, _VP, _CLL]
                       + [_VP, _VP, _VP, _CI] * 5
                       + [_VP, _CI, _CI, _CI, _CI, _VP, _VP, _VP]),
    # count, scratch, NW, pw, state, out_win, out_id, total, stream
    "smr_seed_compact": (_CI, [_VP, _VP, _CI, _CI, _VP, _VP, _VP, _VP, _VP]),
}
COMPACT_BLOCK = 1024      # windows a block of seed_compact (CT in the .cu)

# seed half-widths the kernel takes (the CLI's -L 8..26 gives 4..13)
MIN_PW, MAX_PW = 4, 13


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ids_per_window(pw: int) -> int:
    """Columns of the per-window id matrix: 2 zero-error ids, 4pw+1
    substitutions, 4pw + 4pw insertions, pw x 4 F-prefix, (4pw+1) x 4
    R-exact and pw x 16 R-prefix expansion slots (439 for pw = 9)."""
    return 7 + 48 * pw


class ProbeCapsExceeded(ValueError):
    """The part's group sizes exceed the expansion caps: the device probe
    cannot take it (the engine then uses the host prober)."""


# ---------------------------------------------------------------------------
# the plain PyTorch version


def _mul32(a, m: int):
    """(a * m) mod 2**32 for int64 a in [0, 2**32): two 16-bit halves,
    since an int64 product of two 32-bit values may overflow."""
    return ((a & 0xFFFF) * m + ((((a >> 16) * m) & 0xFFFF) << 16)) \
        & _MASK32


def hash_keys(keys, bits: int):
    """index/hashtab.hash_u64 on an int64 tensor of <= 52-bit keys."""
    h = _mul32(keys & M26, _M1) ^ _mul32((keys >> 26) & _MASK32, _M2)
    h = h ^ (h >> 15)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    return h & ((1 << bits) - 1)


def _probe_table(tk, tv, keys):
    """Linear-probe lookup (twin of seed_search._probe_table): up to
    MAX_PROBES slots, stopping at the key or an empty slot (all ones).
    Returns (found bool[N], value rows of tv[N], zero when not found)."""
    size = tk.shape[0]
    bits = int(size).bit_length() - 1
    cur = hash_keys(keys, bits)
    n = keys.shape[0]
    found = torch.zeros(n, dtype=torch.bool, device=keys.device)
    done = torch.zeros_like(found)
    val = torch.zeros((n,) + tuple(tv.shape[1:]), dtype=tv.dtype,
                      device=keys.device)
    for _ in range(MAX_PROBES):
        if bool(done.all()):
            break
        slot = tk[cur]
        hit = ~done & (slot == keys)
        empty = slot == -1
        val = torch.where(hit.view((n,) + (1,) * (tv.dim() - 1)), tv[cur],
                          val)
        found = found | hit
        done = done | hit | empty
        cur = torch.where(done, cur, (cur + 1) & (size - 1))
    return found, val


def _sub_variants(p, pw):
    """[nw, 4*pw+1]: original + single-char substitutions."""
    cols = [p]
    for i in range(pw):
        shift = 2 * (pw - 1 - i)
        cleared = p & ~(3 << shift)
        for c in range(4):
            cols.append(cleared | (c << shift))
    return torch.stack(cols, dim=1)


def _del_variants(p, pw):
    """[nw, pw] packed (pw-1)-char deletions."""
    cols = []
    for k in range(pw):
        hi = p >> (2 * (pw - k))
        lo = p & ((1 << (2 * (pw - 1 - k))) - 1)
        cols.append((hi << (2 * (pw - 1 - k))) | lo)
    return torch.stack(cols, dim=1)


def _ins9_variants(p, pw):
    """[nw, 4*pw] first pw chars of single insertions."""
    cols = []
    for k in range(pw):
        hi = p >> (2 * (pw - k))
        mid = (p >> 2) & ((1 << (2 * (pw - 1 - k))) - 1)
        for c in range(4):
            cols.append((((hi << 2) | c) << (2 * (pw - 1 - k))) | mid)
    return torch.stack(cols, dim=1)


def _rev(p, width):
    out = torch.zeros_like(p)
    x = p
    for _ in range(width):
        out = (out << 2) | (x & 3)
        x = x >> 2
    return out


def seed_probe_plain(tabs: Dict[str, torch.Tensor], w1, w2, pw: int,
                     full_search: bool, minoccur: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of seed_probe, a line-by-line twin of
    seed_search._probe_kernel up to its flat compaction (and without its
    padding): int64 w1, w2 [nw] -> (count int32 [nw], ids int32 [nw, K]
    holding window w's ascending unique ids in its first count[w]
    columns and BIG after them)."""
    nw = w1.shape[0]
    s = 2 * pw
    counts = tabs["kmer_counts"]
    gate_f = counts[w1] > minoccur
    gate_r = counts[w2] > minoccur

    def probe(name, keys):
        f, v = _probe_table(tabs[name + "_keys"], tabs[name + "_val"],
                            keys.reshape(-1))
        return f.reshape(keys.shape), v.reshape(keys.shape + v.shape[1:])

    # ---------- subsearch 1a ----------
    zf, zid = probe("fx", (w1 << s) | w2)
    zero_a = zf & gate_f
    sf, sid = probe("fx", (w1[:, None] << s) | _sub_variants(w2, pw))
    sf = sf & gate_f[:, None]
    df, dval = probe("fp", (w1[:, None] << (s - 2)) | _del_variants(w2, pw))
    df = df & gate_f[:, None]
    dstart = dval[..., 0]
    dcount = torch.where(df, dval[..., 1], 0)
    inf, inid = probe("k19", (w1[:, None] << (s + 2))
                      | (_ins9_variants(w2, pw) << 2) | (w2 & 3)[:, None])
    inf = inf & gate_f[:, None]

    # ---------- subsearch 1b ----------
    p_r = _rev(w1, pw)
    rzf, rzval = probe("rx", (w1 << s) | w2)
    zero_b = rzf & gate_r
    rsf, rsval = probe("rx", (_rev(_sub_variants(p_r, pw), pw) << s)
                       | w2[:, None])
    rsf = rsf & gate_r[:, None]
    rs_start = rsval[..., 0]
    rs_count = torch.where(rsf, rsval[..., 1], 0)
    rdf, rdval = probe("rp", (_rev(_del_variants(p_r, pw), pw - 1) << s)
                       | w2[:, None])
    rdf = rdf & gate_r[:, None]
    rd_start = rdval[..., 0]
    rd_count = torch.where(rdf, rdval[..., 1], 0)
    rinf, rinid = probe("k19", ((w1 >> (s - 2))[:, None] << (2 * s))
                        | (_rev(_ins9_variants(p_r, pw), pw) << s)
                        | w2[:, None])
    rinf = rinf & gate_r[:, None]

    # ---------- combine (0-error short-circuit semantics) ----------
    if full_search:
        mode_a = torch.zeros_like(zero_a)
        mode_b = torch.zeros_like(zero_b)
    else:
        mode_a = zero_a
        mode_b = zero_b & ~mode_a
    mode_c = ~(mode_a | mode_b)

    r_ids = tabs["r_ids"]
    cm = mode_c[:, None]
    big = torch.tensor(BIG, dtype=torch.int32, device=w1.device)

    def masked(ids, valid):
        return torch.where(valid, ids.to(torch.int32), big)

    cols = [
        masked(zid, mode_a)[:, None],
        masked(rzval[:, 2], mode_b)[:, None],
        masked(sid, sf & cm),
        masked(inid, inf & cm),
        masked(rinid, rinf & cm),
    ]
    # bounded group expansions
    j = torch.arange(CAP_FDEL, dtype=torch.int32, device=w1.device)
    ids = dstart[:, :, None] + j
    cols.append(masked(ids, (j < dcount[:, :, None]) & cm[:, :, None])
                .reshape(nw, -1))
    last = r_ids.shape[0] - 1
    for start, count, cap in ((rs_start, rs_count, CAP_RSUB),
                              (rd_start, rd_count, CAP_RDEL)):
        j = torch.arange(cap, dtype=torch.int32, device=w1.device)
        idx = torch.clamp(start[:, :, None] + j, max=last)
        cols.append(masked(r_ids[idx.long()],
                           (j < count[:, :, None]) & cm[:, :, None])
                    .reshape(nw, -1))

    mat = torch.sort(torch.cat(cols, dim=1), dim=1).values  # [nw, K]
    dup = torch.zeros_like(mat, dtype=torch.bool)
    dup[:, 1:] = mat[:, 1:] == mat[:, :-1]
    valid = (mat != BIG) & ~dup

    # each window's kept ids to the front of its row (the rest to a
    # spare column that is dropped)
    K = mat.shape[1]
    pos = torch.where(valid, valid.cumsum(1) - 1, K)
    ids = torch.full((nw, K + 1), BIG, dtype=torch.int32, device=w1.device)
    ids.scatter_(1, pos, mat)
    return valid.sum(1).to(torch.int32), ids[:, :K].contiguous()


def seed_compact_plain(count, ids):
    """The plain version of seed_compact, the flat compaction of
    _probe_kernel: (win, id) int32, window w's first count[w] ids, windows
    ascending."""
    NW, K = ids.shape
    keep = torch.arange(K, device=ids.device)[None, :] \
        < count.long()[:, None]
    win = torch.arange(NW, dtype=torch.int32, device=ids.device) \
        .repeat_interleave(count.long())
    return win, ids[keep]


def probe_windows_plain(tabs: Dict[str, torch.Tensor], w1, w2, pw: int,
                        full_search: bool, minoccur: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of seed_search._probe_kernel (without its padding and cap):
    int64 w1, w2 [nw] -> (win, id) int32, windows ascending, ids ascending
    and unique inside a window."""
    return seed_compact_plain(*seed_probe_plain(
        tabs, w1, w2, pw, full_search, minoccur))


# ---------------------------------------------------------------------------
# the kernels' wrappers


_TABLES = ("fx", "fp", "rx", "rp", "k19")
# int32 values a slot of each table (0: a plain [size] vector)
VAL_WIDTH = {"fx": 0, "fp": 2, "rx": 3, "rp": 2, "k19": 0}


def _lib() -> ctypes.CDLL:
    return sw_kernels.load_library("seed_probe", SIGNATURES)


def home_bits(keys):
    """The home-slot bitmap of a table: bit h (bit h & 31 of int32 word
    h >> 5) is set when some key's hash, its home slot, is h.  A key whose
    home bit is clear is in no slot of the table.  int32 [ceil(size /
    32)], on the keys' device."""
    size = keys.shape[0]
    h = torch.unique(hash_keys(keys[keys != -1], int(size).bit_length() - 1))
    words = torch.zeros((size + 31) // 32, dtype=torch.int64,
                        device=keys.device)
    words.scatter_add_(0, h >> 5, torch.ones_like(h) << (h & 31))
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def with_home_bits(tabs):
    """``tabs`` with each table's home-slot bitmap (``<name>_home``), which
    the seed_probe kernel reads before the table's keys."""
    return dict(tabs, **{name + "_home": home_bits(tabs[name + "_keys"])
                         for name in _TABLES})


def _check_tables(tabs, pw: int, device) -> None:
    """The tables as the kernel reads them: int64 keys of a power of two
    >= 4 slots (32-byte aligned on the card), int32 value rows of the
    table's width, int32 r_ids (at least one), int64 kmer_counts over every
    pw-mer; on the card also each table's home bitmap (``with_home_bits``);
    all contiguous on ``device``."""
    if not MIN_PW <= pw <= MAX_PW:
        raise ValueError(f"seed half-width {pw} is outside "
                         f"{MIN_PW}..{MAX_PW}")
    for k, t in tabs.items():
        dtype = torch.int64 if k.endswith("_keys") or k == "kmer_counts" \
            else torch.int32
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"table {k} must be a contiguous {dtype} "
                             f"tensor on {device}")
    for name in _TABLES:
        keys, vals = tabs[name + "_keys"], tabs[name + "_val"]
        size = keys.shape[0]
        width = VAL_WIDTH[name]
        want = (size, width) if width else (size,)
        if keys.dim() != 1 or size < 4 or size & (size - 1) \
                or tuple(vals.shape) != want \
                or (device.type == "cuda" and keys.data_ptr() % 32):
            raise ValueError(f"table {name}: keys must be a 32-byte aligned "
                             f"power of two >= 4 slots, values {want}")
        home = tabs.get(name + "_home")
        if device.type == "cuda" and (
                home is None or tuple(home.shape) != ((size + 31) // 32,)):
            raise ValueError(f"table {name}: the kernel needs its home "
                             "bitmap (with_home_bits)")
    if tabs["r_ids"].dim() != 1 or tabs["r_ids"].shape[0] < 1 \
            or tabs["kmer_counts"].shape != (1 << (2 * pw),):
        raise ValueError("r_ids must hold at least one id, kmer_counts "
                         f"one count for each {pw}-mer")


def seed_probe(tabs, w1, w2, pw: int, full_search: bool, minoccur: int,
               out=None):
    """int32 w1, w2 [NW] -> (count int32 [NW], ids int32 [NW,
    ids_per_window(pw)]; row w holds window w's ascending unique ids in
    its first count[w] columns): the seed_probe kernel on CUDA tensors,
    into ``out`` = (count, ids) when given; seed_probe_plain on CPU
    tensors."""
    device = sw_kernels._on_device(w1, "w1")
    NW = w1.shape[0]
    for name, t in (("w1", w1), ("w2", w2)):
        if t.device != device or t.dtype != torch.int32 \
                or tuple(t.shape) != (NW,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{NW}] "
                             f"tensor on {device}")
    _check_tables(tabs, pw, device)
    if device.type == "cpu":
        return seed_probe_plain(tabs, w1.long(), w2.long(), pw, full_search,
                                minoccur)
    K = ids_per_window(pw)
    if out is None:
        out = (torch.empty(NW, dtype=torch.int32, device=device),
               torch.empty((NW, K), dtype=torch.int32, device=device))
    count, ids = out
    for name, t, shape in (("count", count, (NW,)), ("ids", ids, (NW, K))):
        sw_kernels._check(t, name, torch.int32, shape, device)
    args = [w1.data_ptr(), w2.data_ptr(), tabs["kmer_counts"].data_ptr(),
            int(minoccur)]
    for name in _TABLES:
        keys = tabs[name + "_keys"]
        args += [keys.data_ptr(), tabs[name + "_val"].data_ptr(),
                 tabs[name + "_home"].data_ptr(),
                 int(keys.shape[0]).bit_length() - 1]
    args += [tabs["r_ids"].data_ptr(), int(tabs["r_ids"].shape[0]), NW,
             int(pw), int(bool(full_search)), count.data_ptr(),
             ids.data_ptr(), torch.cuda.current_stream(device).cuda_stream]
    lib = _lib()
    # the tensors' device is the current one for the launch
    with torch.cuda.device(device):
        err = lib.smr_seed_probe(*args)
    sw_kernels._raise_on(err, "seed_probe")
    sw_kernels.count_launch("seed_probe", LAUNCHES)
    return count, ids


def compact_state_words(NW: int) -> int:
    """int64 words of seed_compact's state for NW windows: the block
    ticket, then a (flag, sum) word for each block."""
    return 1 + -(-NW // COMPACT_BLOCK)


def seed_compact(count, ids, pw: int, out=None):
    """seed_probe's (count, ids) -> (win, id, total): the (window, id)
    int32 pairs, windows ascending, in the first ``total`` entries of
    ``win`` and ``id`` (``total`` an int32 [1] tensor on their device).
    On CUDA tensors the seed_compact kernel, which scans the counts for
    its offsets in the same launch, writes them into ``out`` = (win, id,
    total, state) when given: int32 buffers of at least NW *
    ids_per_window(pw) entries, the int32 [1] total and the kernel's int64
    state (``compact_state_words(NW)``); on CPU tensors
    seed_compact_plain gives exactly ``total``."""
    device = sw_kernels._on_device(count, "count")
    NW = count.shape[0]
    K = ids_per_window(pw)
    if ids.shape != (NW, K) or ids.device != device \
            or ids.dtype != torch.int32 or count.dtype != torch.int32 \
            or not (ids.is_contiguous() and count.is_contiguous()):
        raise ValueError("seed_compact takes seed_probe's count and ids")
    if device.type == "cpu":
        win, got = seed_compact_plain(count, ids)
        return win, got, torch.tensor([len(got)], dtype=torch.int32)
    words = compact_state_words(NW)
    if out is None:
        out = (torch.empty(NW * K, dtype=torch.int32, device=device),
               torch.empty(NW * K, dtype=torch.int32, device=device),
               torch.empty(1, dtype=torch.int32, device=device),
               torch.empty(words, dtype=torch.int64, device=device))
    win, got, total, state = out
    for name, t, n, dtype in (("win", win, NW * K, torch.int32),
                              ("id", got, NW * K, torch.int32),
                              ("total", total, 1, torch.int32),
                              ("state", state, words, torch.int64)):
        if t.device != device or t.dtype != dtype or t.dim() != 1 \
                or t.shape[0] < n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of >= {n} entries on {device}")
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.smr_seed_compact(
            count.data_ptr(), ids.data_ptr(), NW, int(pw), state.data_ptr(),
            win.data_ptr(), got.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    sw_kernels._raise_on(err, "seed_compact")
    sw_kernels.count_launch("seed_compact", LAUNCHES)
    return win, got, total


def probe_windows(tabs, w1, w2, pw: int, full_search: bool, minoccur: int,
                  bufs=None):
    """(win, id, total) of a window batch: seed_probe then seed_compact,
    into ``bufs`` (the searcher's persistent buffers) when given."""
    bufs = bufs or {}
    count, ids = seed_probe(tabs, w1.to(torch.int32).contiguous(),
                            w2.to(torch.int32).contiguous(), pw,
                            full_search, minoccur, out=bufs.get("probe"))
    return seed_compact(count, ids, pw, out=bufs.get("compact"))


# ---------------------------------------------------------------------------


class DeviceSeedSearcher:
    """The device prober of one IndexPart: the twin of the JAX package's
    DeviceSeedSearcher, on ``device`` (default ``cuda``; raises without a
    GPU unless the caller asks for ``cpu``)."""

    # windows per call: the plain version's [nw, 439] id matrix and the
    # kernel's scratch of the same size are the peak (115 MB int32 at
    # 64K, as are each of the two output buffers); bigger batches split,
    # as in the JAX package
    MAX_WINDOWS = 65536

    def __init__(self, part: IndexPart, minoccur: int = 0,
                 full_search: bool = False, device=None):
        self.device = resolve_device(device)
        self.minoccur = int(minoccur)
        self.full_search = bool(full_search)
        self.pw = getattr(part, "seed_win_len", 18) // 2
        if ((len(part.f_pref_count)
             and int(part.f_pref_count.max()) > CAP_FDEL)
                or (len(part.r_exact_count)
                    and int(part.r_exact_count.max()) > CAP_RSUB)
                or (len(part.r_pref_count)
                    and int(part.r_pref_count.max()) > CAP_RDEL)):
            raise ProbeCapsExceeded(
                "index group sizes exceed device probe caps")
        self._bufs = None
        # a search owns the buffers from its first launch until its host
        # copies are done: read shards call one searcher from several
        # threads, and a ctypes launch releases the GIL
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            _lib()                      # build now: fail before any probe

        def put(a, dtype=np.int32):
            # uint32 values wrap to int32 as the JAX package casts them;
            # uint64 keys keep their bit pattern (EMPTY = -1)
            a = np.ascontiguousarray(a)
            a = a.view(np.int64) if a.dtype == np.uint64 else a.astype(dtype)
            return torch.tensor(a, device=self.device)

        self.tabs = with_home_bits({
            "fx_keys": put(part.f_exact_keys),
            "fx_val": put(part.f_exact_vals),
            "fp_keys": put(part.f_pref_keys),
            "fp_val": put(np.stack([part.f_pref_start, part.f_pref_count],
                                   axis=1)),
            "rx_keys": put(part.r_exact_keys),
            "rx_val": put(np.stack([part.r_exact_start, part.r_exact_count,
                                    part.r_exact_zero], axis=1)),
            "rp_keys": put(part.r_pref_keys),
            "rp_val": put(np.stack([part.r_pref_start, part.r_pref_count],
                                   axis=1)),
            "k19_keys": put(part.k19_keys),
            "k19_val": put(part.k19_vals),
            "r_ids": put(part.r_ids if len(part.r_ids)
                         else np.zeros(1, np.uint32)),
            "kmer_counts": put(part.kmer_counts, np.int64),
        })

    def search_windows(self, w1: np.ndarray, w2: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(window, id) int64 pairs of the windows w1.w2 (packed pw-mers),
        windows ascending, ids ascending and unique inside a window."""
        w1 = np.asarray(w1, np.int64)
        w2 = np.asarray(w2, np.int64)
        nw = len(w1)
        if nw == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if nw > self.MAX_WINDOWS:
            # split oversized batches; windows are independent
            mid = nw // 2
            wA, iA = self.search_windows(w1[:mid], w2[:mid])
            wB, iB = self.search_windows(w1[mid:], w2[mid:])
            return np.concatenate([wA, wB + mid]), np.concatenate([iA, iB])
        hi = 1 << (2 * self.pw)
        if min(w1.min(), w2.min()) < 0 or max(w1.max(), w2.max()) >= hi:
            raise ValueError(f"window halves must be packed {self.pw}-mers "
                             f"in [0, {hi})")
        with self._lock:
            win, ids, total = probe_windows(
                self.tabs, torch.from_numpy(w1).to(self.device),
                torch.from_numpy(w2).to(self.device), self.pw,
                self.full_search, self.minoccur, self._buffers(nw))
            n = int(total[0])           # waits for both kernels
            return (win[:n].cpu().numpy().astype(np.int64),
                    ids[:n].cpu().numpy().astype(np.int64))

    def _buffers(self, nw: int):
        """The kernels' outputs for nw windows, views of buffers made once
        at MAX_WINDOWS (none on cpu); the caller holds ``self._lock``."""
        if self.device.type != "cuda":
            return None
        K = ids_per_window(self.pw)
        if self._bufs is None:
            def empty(*shape):
                return torch.empty(shape, dtype=torch.int32,
                                   device=self.device)
            self._bufs = dict(
                count=empty(self.MAX_WINDOWS),
                ids=empty(self.MAX_WINDOWS, K),
                win=empty(self.MAX_WINDOWS * K),
                id=empty(self.MAX_WINDOWS * K), total=empty(1),
                state=torch.empty(compact_state_words(self.MAX_WINDOWS),
                                  dtype=torch.int64, device=self.device))
        b = self._bufs
        return {"probe": (b["count"][:nw], b["ids"][:nw]),
                "compact": (b["win"][:nw * K], b["id"][:nw * K],
                            b["total"], b["state"])}
