"""Plain Levenshtein-NFA oracle for the d=1 seed automaton (tests only).

Simulates the nondeterministic Levenshtein automaton position sets directly
to reproduce the acceptance behavior of the reference's table-driven
universal automaton (traverse_bursttrie.cpp:100-298): a hit is recorded at
the first c in {8, 9, 10} consumed tail chars where the automaton accepts,
and a 0-error match is flagged at c == 9 when the word prefix equals the
pattern exactly.
"""

from __future__ import annotations

from typing import List, Set, Tuple


def _step(states: Set[Tuple[int, int]], pattern: List[int], ch: int,
          d: int = 1) -> Set[Tuple[int, int]]:
    """One NFA step: states = {(i, e)}, i = pattern chars consumed."""
    m = len(pattern)
    nxt: Set[Tuple[int, int]] = set()
    for (i, e) in states:
        if i < m and pattern[i] == ch:
            nxt.add((i + 1, e))            # match
        if e < d:
            if i < m:
                nxt.add((i + 1, e + 1))    # substitution
            nxt.add((i, e + 1))            # insertion (extra word char)
    # epsilon closure: deletions (skip pattern chars)
    closed = set(nxt)
    frontier = list(nxt)
    while frontier:
        i, e = frontier.pop()
        if e < d and i < m and (i + 1, e + 1) not in closed:
            closed.add((i + 1, e + 1))
            frontier.append((i + 1, e + 1))
    return closed


def _accepting(states: Set[Tuple[int, int]], m: int, d: int = 1) -> bool:
    return any((m - i) + e <= d for (i, e) in states)


def accept_tail_nfa(word10: List[int], pattern9: List[int]
                    ) -> Tuple[bool, bool]:
    """Return (hit, zero) for a 10-char tail vs a 9-char pattern.

    hit: automaton accepting after 8, 9 or 10 consumed chars.
    zero: word[0:9] == pattern (the reference's state-9 check at
    depth_b == partialwin-1).
    """
    m = len(pattern9)
    states: Set[Tuple[int, int]] = {(0, 0)}
    # initial epsilon closure
    states = states | {(1, 1)}
    hit = False
    zero = False
    for c, ch in enumerate(word10, start=1):
        states = _step(states, pattern9, ch)
        if not states:
            break
        if c >= m - 1 and _accepting(states, m):
            hit = True
        if c == m and word10[:m] == pattern9:
            zero = True
    return hit, zero
