"""Open-addressing hash tables over <=52-bit integer keys.

Replaces the reference's CMPH minimal perfect hash (3rdparty/cmph, used at
indexdb.cpp:1571-1587) with an ordinary power-of-two open-addressing table
built on the host (numpy) and probed on the device (JAX gathers).

The hash function uses only 32-bit wrapping multiplies so it can be
evaluated identically in numpy (uint64 intermediate) and on TPU (int32/
uint32 lanes).  Keys are split into hi/lo 26-bit halves (52 bits covers
every key class up to seed length L=26: 2L-bit exact keys, (2L+2)-bit
insertion keys).

Layout: keys array (uint64, EMPTY = all-ones sentinel) and a value array
(uint32 or uint32 pairs).  Linear probing; the builder guarantees the load
factor <= 0.5 so expected probe chains are short; MAX_PROBES bounds the
device-side loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
MAX_PROBES = 32

_M1 = np.uint64(0x9E3779B1)   # 32-bit golden-ratio constants
_M2 = np.uint64(0x85EBCA77)
_MASK32 = np.uint64(0xFFFFFFFF)


def hash_u64(keys: np.ndarray, table_bits: int) -> np.ndarray:
    """32-bit mix of a <=52-bit key -> slot index.

    keys: uint64 array.  Must match _hash26 in ops/seed_search.py and
    hash26 in native/probe.cpp.
    """
    k = keys.astype(np.uint64)
    lo = k & np.uint64(0x3FFFFFF)          # low 26 bits
    hi = k >> np.uint64(26)                # high <=26 bits
    h = (lo * _M1) & _MASK32
    h ^= (hi * _M2) & _MASK32
    h &= _MASK32
    h ^= h >> np.uint64(15)
    h = (h * _M1) & _MASK32
    h ^= h >> np.uint64(13)
    return (h & np.uint64((1 << table_bits) - 1)).astype(np.int64)


def build_hash_u64(keys: np.ndarray, values: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Build an open-addressing table; returns (table_keys, table_values).

    ``values`` may be shape [n] or [n, k]; the value table mirrors that
    shape.  Table size is the smallest power of two >= 2*n (min 16).
    """
    n = int(keys.shape[0])
    bits = 4
    while (1 << bits) < 2 * max(n, 1):
        bits += 1

    while True:
        size = 1 << bits
        tk = np.full(size, EMPTY_KEY, dtype=np.uint64)
        if values.ndim == 1:
            tv = np.zeros(size, dtype=values.dtype)
        else:
            tv = np.zeros((size,) + values.shape[1:], dtype=values.dtype)

        slots = hash_u64(keys, bits)
        ok = _insert_all(tk, tv, keys, values, slots, size)
        if ok:
            return tk, tv
        bits += 1  # extremely unlikely; grow and retry


def _insert_all(tk, tv, keys, values, slots, size) -> bool:
    """Vectorized-ish batched insertion with linear probing."""
    pending = np.arange(keys.shape[0])
    cur = slots.copy()
    for _probe in range(MAX_PROBES):
        if pending.size == 0:
            return True
        # attempt to claim slots; collisions within the batch resolved by
        # letting the first writer win (np assigns in order; recheck after)
        free = tk[cur[pending]] == EMPTY_KEY
        cand = pending[free]
        # first occurrence per slot wins
        slot_of = cur[cand]
        _, first = np.unique(slot_of, return_index=True)
        winners = cand[first]
        tk[cur[winners]] = keys[winners]
        tv[cur[winners]] = values[winners]
        # recompute pending: keys not yet stored at their current slot
        placed = tk[cur[pending]] == keys[pending]
        # guard: duplicate keys are a build error
        still = pending[~placed]
        cur[still] = (cur[still] + 1) % size
        pending = still
    return pending.size == 0


def lookup_u64(tk: np.ndarray, tv: np.ndarray, keys: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side probe (for tests / host engine).

    Returns (found_mask, values) where values rows are zero when not found.
    """
    size = tk.shape[0]
    bits = int(size).bit_length() - 1
    cur = hash_u64(keys, bits)
    found = np.zeros(keys.shape[0], dtype=bool)
    if tv.ndim == 1:
        out = np.zeros(keys.shape[0], dtype=tv.dtype)
    else:
        out = np.zeros((keys.shape[0],) + tv.shape[1:], dtype=tv.dtype)
    active = np.arange(keys.shape[0])
    for _probe in range(MAX_PROBES):
        if active.size == 0:
            break
        slot_keys = tk[cur[active]]
        hit = slot_keys == keys[active]
        idx_hit = active[hit]
        found[idx_hit] = True
        out[idx_hit] = tv[cur[idx_hit]]
        empty = slot_keys == EMPTY_KEY
        done = hit | empty
        active = active[~done]
        cur[active] = (cur[active] + 1) % size
    return found, out
