"""Nucleotide encoding tables and shared constants.

These tables define the behavioral contract of the engine and mirror the
reference semantics (see /root/reference include/common.hpp:57-95 and
src/sortmerna/indexdb.cpp:59-109):

* ``NT_TABLE``    -- char -> int for reads and alignment-time references
                     (A/a=0, C/c=1, G/g=2, T/t/U/u=3, everything else 4=N).
* ``MAP_NT``      -- char -> int used ONLY by the index builder; ambiguity
                     codes are folded onto concrete nucleotides so every
                     reference position participates in k-mer indexing.
* ``COMPLEMENT4`` -- int complement in the 0..4 alphabet (A<->T, C<->G, N->N).
* ``NT_MAP``      -- int -> char ('A','C','G','T','N').
"""

import numpy as np

# --- alphabet -------------------------------------------------------------

A, C, G, T, N = 0, 1, 2, 3, 4

NT_MAP = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement in integer alphabet: A<->T, C<->G, N->N (common.hpp:94)
COMPLEMENT4 = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

# char -> int, ambiguous -> 4 (common.hpp:68-77)
NT_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    NT_TABLE[ord(_ch)] = _v
    NT_TABLE[ord(_ch.lower())] = _v

# char -> int for the index builder; ambiguity codes folded to ACGT
# (indexdb.cpp:83-109 'map_nt', transcribed from the data table, upper and
# lower case rows; unlisted chars map to 0).
MAP_NT = np.zeros(256, dtype=np.uint8)
_MAP_NT_UPPER = {
    "A": 0, "B": 1, "C": 1, "D": 1,
    "G": 2, "K": 2, "S": 2, "T": 3, "U": 3,
    "W": 1, "X": 2, "Y": 1,
}
# lower-case row of the table differs slightly from upper case
# (indexdb.cpp:98-109): a=0 b=1 c=1 d=0 g=2 k=2 s=2 t=3 u=3 w=1 x=2 y=1
_MAP_NT_LOWER = {
    "a": 0, "b": 1, "c": 1, "d": 0,
    "g": 2, "k": 2, "s": 2, "t": 3, "u": 3,
    "w": 1, "x": 2, "y": 1,
}
for _ch, _v in _MAP_NT_UPPER.items():
    MAP_NT[ord(_ch)] = _v
for _ch, _v in _MAP_NT_LOWER.items():
    MAP_NT[ord(_ch)] = _v

# --- seed geometry (options.hpp:584-587) ---------------------------------

SEED_WIN_LEN = 18          # L, the seed (18-mer) length; --L
PARTIAL_WIN = SEED_WIN_LEN // 2   # 9
PREAD = SEED_WIN_LEN + 1   # 19-mer indexing window
MAX_READ_LEN = 30000       # options.hpp:57

# --- SW scoring defaults (options.hpp:567-587) ---------------------------

DEFAULT_MATCH = 2
DEFAULT_MISMATCH = -3
DEFAULT_GAP_OPEN = 5
DEFAULT_GAP_EXT = 2
DEFAULT_SCORE_N = 0
DEFAULT_NUM_ALIGNMENTS = 1
DEFAULT_NUM_SEEDS = 2
DEFAULT_MIN_LIS = 2
DEFAULT_EVALUE = 1.0
DEFAULT_EDGES = 4
DEFAULT_MAX_POS = 10000
DEFAULT_INTERVAL = 1
DEFAULT_MAX_FILE_SIZE = 3072.0  # MB


def scoring_matrix_5x5(match: int, mismatch: int, score_n: int) -> np.ndarray:
    """5x5 substitution matrix over {A,C,G,T,N} (read.cpp:274-288).

    Diagonal = match, off-diagonal = mismatch, any pairing involving N
    scores ``score_n``.
    """
    m = np.full((5, 5), mismatch, dtype=np.int8)
    np.fill_diagonal(m, match)
    m[4, :] = score_n
    m[:, 4] = score_n
    return m
