"""Closed-form seed acceptance math (replaces the Levenshtein automaton).

The reference matches a read half-window P (9 chars) against reference
k-mer tails W (10 chars) with a universal Levenshtein automaton for d=1
(traverse_bursttrie.cpp:44-298, bitvector.cpp).  A tail is accepted iff the
automaton is in an accepting state after consuming c chars for any
c in {8, 9, 10} (checks at depth_b >= partialwin-2,
traverse_bursttrie.cpp:229-247), which is equivalent to:

    accept(W, P)  <=>  ed(W[0:8], P) <= 1      (one deletion)
                    or ed(W[0:9], P) <= 1      (<=1 substitution)
                    or ed(W[0:10], P) <= 1     (one insertion)

    zero(W, P)    <=>  W[0:9] == P             (state 9 at depth_b==8)

With L = length of the longest common prefix of W[0:9] and P, each branch
reduces to a single masked XOR over 2-bit-packed strings:

    del:  W[L:8]   == P[L+1:9]
    sub:  W[L+1:9] == P[L+1:9]
    ins:  W[L+1:10]== P[L:9]

These identities are used both to *probe* (enumerating the accepted
neighborhood of P against the index hash tables) and to *verify* in tests
against the NFA oracle in seed_nfa.py.

All functions are pure array math over integer dtypes (numpy by default;
another array module may be passed as ``xp``).
"""

from __future__ import annotations

import numpy as np

MASK18 = (1 << 18) - 1


def pack9(chars: np.ndarray, xp=np, pw: int = 9) -> np.ndarray:
    """Pack pw chars (last axis) MSB-first into a 2*pw-bit integer."""
    out = xp.zeros(chars.shape[:-1], dtype=xp.int64 if xp is not np else np.int64)
    for k in range(pw):
        out = (out << 2) | chars[..., k].astype(out.dtype)
    return out


def accept_tail(w10_packed, p9_packed, xp=np, pw: int = 9):
    """Vectorized acceptance of (pw+1)-char tails against a pw-char
    pattern.

    w10_packed: int64 (2*pw+2 bit) packed tail, MSB-first.
    p9_packed:  int64 (2*pw bit) packed pattern.
    Returns (accept, zero) boolean arrays.

    This is the *verification* form (used in tests and by the scalar
    engine); the production path inverts it into hash probes, see
    `enumerate_probes`.
    """
    mask_half = (1 << (2 * pw)) - 1
    w9 = (w10_packed >> 2) & mask_half
    x = w9 ^ p9_packed
    zero = x == 0
    # L = index of first mismatching char; bit position of highest set bit
    nbits = _bit_length(x, xp)            # 0 when x == 0
    L = xp.where(zero, pw, (pw - 1) - (nbits - 1) // 2)
    mask_sub = (1 << (2 * (pw - 1 - L)).astype(w9.dtype)) - 1
    sub = (x & mask_sub) == 0
    d = ((w10_packed >> 4) ^ p9_packed) & mask_sub
    del_ = d == 0
    mask_ins = (1 << (2 * (pw - L)).astype(w9.dtype)) - 1   # pairs L..pw-1
    ins = ((w10_packed ^ p9_packed) & mask_ins) == 0
    return zero | sub | del_ | ins, zero


def _bit_length(x, xp):
    """Number of bits of x (int64, x >= 0)."""
    if xp is np:
        # vectorized bit_length
        out = np.zeros_like(x)
        v = x.copy()
        for shift in (32, 16, 8, 4, 2, 1):
            ge = v >= (1 << shift)
            out = out + np.where(ge, shift, 0)
            v = np.where(ge, v >> shift, v)
        return out + (v > 0)
    else:
        out = xp.zeros_like(x)
        v = x
        for shift in (32, 16, 8, 4, 2, 1):
            ge = v >= (1 << shift)
            out = out + xp.where(ge, shift, 0)
            v = xp.where(ge, v >> shift, v)
        return out + (v > 0)


def sub_variants_packed(p9: int) -> np.ndarray:
    """All 18-bit packed strings with hamming distance <= 1 from p9.

    Returns 28 values: p9 itself + 27 single-substitution variants (some may
    duplicate p9 when enumerating the original char; they are emitted with
    the original first so hash-probe de-dup keeps deterministic order).
    """
    out = [p9]
    for i in range(9):
        shift = 2 * (8 - i)
        cur = (p9 >> shift) & 3
        for c in range(4):
            if c != cur:
                out.append((p9 & ~(3 << shift)) | (c << shift))
    return np.asarray(out, dtype=np.int64)


def del_variants_packed(p9: int) -> np.ndarray:
    """The 9 16-bit packed 8-char strings: p9 with one char deleted.

    Result chars MSB-first (8 chars = 16 bits).
    """
    out = []
    for k in range(9):
        hi = p9 >> (2 * (9 - k))            # chars 0..k-1
        lo = p9 & ((1 << (2 * (8 - k))) - 1)  # chars k+1..8
        out.append((hi << (2 * (8 - k))) | lo)
    return np.asarray(out, dtype=np.int64)


def ins_variants_packed(p9: int) -> np.ndarray:
    """The 10-char packed strings (20 bits): p9 with one char inserted.

    36 values (9 interior+0 positions x 4 chars; position 9 insertion is the
    trailing char which is unconstrained in the first 9 chars -- handled by
    returning position k in [0..8] only, plus the 'append' case separately).

    Actually for the probe enumeration only the FIRST 9 chars of the
    insertion variant matter together with the constraint that the 10th
    char equals P[8]; see `enumerate_probes`.
    """
    out = []
    for k in range(9):
        hi = p9 >> (2 * (9 - k))
        lo = p9 & ((1 << (2 * (9 - k))) - 1)
        for c in range(4):
            out.append((((hi << 2) | c) << (2 * (9 - k))) | lo)
    return np.asarray(out, dtype=np.int64)


def ins9_variants_packed(p9: int) -> np.ndarray:
    """First 9 chars of each insertion variant: insert(P,k,c)[0:9].

    For k in 0..8, c in 0..3:  P[0:k] + c + P[k:8]   (drops P[8]).
    36 packed 18-bit values (may contain duplicates).
    The k==9 'append' case gives exactly P itself and needs no probe beyond
    the exact-match probe (19-mer P + trailing char == P[8]... no:
    append case => W[0:9] == P and W[9] == anything is NOT the constraint;
    see enumerate below -- the c==10 acceptance for k==9 means W==P+c where
    the inserted char c is W[9]; but acceptance also requires nothing else;
    that case is covered by the zero/sub probes since W[0:9]==P).
    """
    out = []
    for k in range(9):
        hi = p9 >> (2 * (9 - k))                  # chars 0..k-1
        mid_lo = (p9 >> 2) & ((1 << (2 * (8 - k))) - 1)  # chars k..7
        for c in range(4):
            out.append((((hi << 2) | c) << (2 * (8 - k))) | mid_lo)
    return np.asarray(out, dtype=np.int64)
