"""Longest increasing subsequence over seed hits.

Outcome-equivalent to the reference's construction (find_lis,
alignment.cpp:58-98): the engine anchors the SW window on the FIRST
element of the returned subsequence (alignment.cpp:268-269), so both the
membership of the run and its reconstruction must match.  Behavioral
contract reproduced here:

* strictly increasing in the READ position (pair[1]);
* patience placement with "equal keeps the earlier entry" -- a hit whose
  read position ties a pile top never displaces it;
* the run is rebuilt through predecessor links starting from the top of
  the last pile.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import List, Sequence, Tuple


def find_lis(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """Indices (into ``pairs``) of one longest strictly-increasing run of
    read positions, selected by patience piles with predecessor links."""
    if not pairs:
        return []
    tops: List[int] = []      # read position currently topping each pile
    top_at: List[int] = []    # which hit index tops each pile
    prev = [-1] * len(pairs)  # predecessor hit in the reconstructed run
    for i, (_ref_pos, read_pos) in enumerate(pairs):
        pile = bisect_left(tops, read_pos)
        if pile == len(tops):
            tops.append(read_pos)
            top_at.append(i)
        elif read_pos < tops[pile]:
            tops[pile] = read_pos
            top_at[pile] = i
        else:
            continue          # tie on the pile top: earlier entry wins
        if pile:
            prev[i] = top_at[pile - 1]
    run: List[int] = []
    i = top_at[-1]
    while i >= 0:
        run.append(i)
        i = prev[i]
    run.reverse()
    return run
