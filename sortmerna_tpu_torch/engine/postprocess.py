"""Post-alignment passes: de-novo classification and OTU map.

Ports denovo_stats (processor.cpp:287-438) and fill_otu_map
(otumap.cpp:131-281): a sweep over reference parts re-deriving %id/%cov
from each stored CIGAR, with 3-decimal rounding, classifying alignments
into {yid_ycov, yid_ncov, nid_ycov, denovo} and building the
ref-id -> [read-ids] OTU map.
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..reports.blast import calc_miss_gap_match
from .candidates import Readstats
from .read import ReadSeq, ReadState


def denovo_stats_part(reads: List[ReadSeq], states: List[ReadState],
                      refs_seqs, index_num: int, part_num: int,
                      min_id: float, min_cov: float,
                      readstats: Readstats) -> None:
    """One (index, part) sweep of the denovo classification
    (denovo_stats_run, processor.cpp:329-358)."""
    for read, st in zip(reads, states):
        for aln in st.alignments:
            if aln.index_num != index_num or aln.part != part_num:
                continue
            # consult the batched-precompute cache BEFORE touching the
            # read encodings (strand04 is only needed on a cache miss)
            m = aln.mgm
            if m is None:
                m = calc_miss_gap_match(
                    refs_seqs[aln.ref_num], read.strand04(aln.strand),
                    aln)
            _, _, _, idr_raw, cov_raw = m
            idr = math.floor(idr_raw * 1000.0 + 0.5) / 1000.0
            covr = math.floor(cov_raw * 1000.0 + 0.5) / 1000.0
            is_id = idr >= min_id
            is_cov = covr >= min_cov
            if is_id and is_cov:
                st.c_yid_ycov += 1
                readstats.n_yid_ycov += 1
            elif is_id:
                st.n_yid_ncov += 1
                readstats.n_yid_ncov += 1
            elif is_cov:
                st.n_nid_ycov += 1
                readstats.n_nid_ycov += 1
            else:
                st.n_denovo += 1
                readstats.num_denovo += 1


def fill_otu_map_part(reads: List[ReadSeq], states: List[ReadState],
                      refs_seqs, refs_headers, index_num: int,
                      part_num: int, min_id: float, min_cov: float,
                      otu_map: Dict[str, List[str]]) -> None:
    """One (index, part) sweep of OTU map filling
    (fill_otu_map2, otumap.cpp:144-190)."""
    for read, st in zip(reads, states):
        if st.c_yid_ycov <= 0:
            continue
        for aln in st.alignments:
            if aln.index_num != index_num or aln.part != part_num:
                continue
            m = aln.mgm
            if m is None:
                m = calc_miss_gap_match(
                    refs_seqs[aln.ref_num], read.strand04(aln.strand),
                    aln)
            _, _, _, idr_raw, cov_raw = m
            idr = math.floor(idr_raw * 1000.0 + 0.5) * 0.001
            covr = math.floor(cov_raw * 1000.0 + 0.5) * 0.001
            if idr >= min_id and covr >= min_cov:
                ref_id = refs_headers[aln.ref_num].split(" ", 1)[0] \
                    .split("\t", 1)[0]
                otu_map.setdefault(ref_id, []).append(read.seq_id)


def write_otu_map(otu_map: Dict[str, List[str]], path: str) -> int:
    """TSV 'ref \\t read1 \\t read2 ...' (OtuMap::write, otumap.cpp:72-105).
    Returns the number of OTU groups."""
    with open(path, "w") as f:
        for ref, read_ids in otu_map.items():
            f.write(ref + "\t" + "\t".join(read_ids) + "\n")
    return len(otu_map)
