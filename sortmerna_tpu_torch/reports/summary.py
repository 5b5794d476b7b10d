"""aligned.log summary writer (summary.cpp:58-188)."""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np

from ..engine.candidates import Readstats
from ..options import RunOptions
from ..stats.refstats import Refstats


def summary_text(opts: RunOptions, refstats: Refstats,
                 readstats: Readstats, total_otu: int = 0,
                 pid: int = None, timestamp: str = None) -> str:
    """Byte layout of Summary::to_string (summary.cpp:102-175)."""
    if pid is None:
        pid = os.getpid()
    s = []
    s.append(f" Command:\n    {opts.cmdline}\n\n")
    s.append(f" Process pid = {pid}\n\n")
    s.append(" Parameters summary: \n")
    for i, ref in enumerate(opts.ref_files):
        lam, K = refstats.gumbel[i]
        s.append(f"    Reference file: {ref}\n")
        s.append(f"        Seed length = {opts.seed_win_len}\n")
        s.append(f"        Pass 1 = {opts.skiplengths[i][0]}"
                 f", Pass 2 = {opts.skiplengths[i][1]}"
                 f", Pass 3 = {opts.skiplengths[i][2]}\n")
        s.append(f"        Gumbel lambda = {lam:.6g}\n")
        s.append(f"        Gumbel K = {K:.6g}\n")
        s.append(f"        Minimal SW score based on E-value = "
                 f"{refstats.minimal_score[i]}\n")
    s.append(f"    Number of seeds = {opts.num_seeds}\n")
    s.append(f"    Edges = {opts.edges}\n")
    s.append(f"    SW match = {opts.match}\n")
    s.append(f"    SW mismatch = {opts.mismatch}\n")
    s.append(f"    SW gap open penalty = {opts.gap_open}\n")
    s.append(f"    SW gap extend penalty = {opts.gap_ext}\n")
    s.append(f"    SW ambiguous nucleotide = {opts.score_n}\n")
    s.append("    SQ tags are " + ("" if opts.is_SQ else "not ")
             + "output\n")
    s.append(f"    Number of alignment processing threads = "
             f"{opts.num_proc_thread}\n")
    for rf in opts.reads_files:
        s.append(f"    Reads file: {rf}\n")
    s.append(f"    Total reads = {readstats.all_reads_count}\n\n")

    s.append(" Results:\n")
    if opts.is_denovo:
        s.append(f"    Total reads for de novo clustering = "
                 f"{readstats.num_denovo}\n")
    total = readstats.all_reads_count
    mapped = readstats.num_aligned
    ratio = float(np.float32(mapped) / np.float32(total)) if total else 0.0
    s.append(f"    Total reads passing E-value threshold = {mapped}"
             f" ({ratio * 100:.2f})\n")
    s.append(f"    Total reads failing E-value threshold = "
             f"{total - mapped} ({(1 - ratio) * 100:.2f})\n")
    if opts.is_otu_map:
        idcov = readstats.n_yid_ycov
        r2 = float(np.float32(idcov) / np.float32(total)) if total else 0.0
        s.append(f"    Total reads passing %%id and %%coverage thresholds"
                 f" = {idcov} ({r2 * 100:.2f})\n")
        s.append(f"    Total OTUs = {total_otu}\n")
    mean_len = readstats.all_reads_len // total if total else 0
    s.append(f"    Minimum read length = {readstats.min_read_len}\n")
    s.append(f"    Maximum read length = {readstats.max_read_len}\n")
    s.append(f"    Mean read length    = {mean_len}\n\n")

    s.append(" Coverage by database:\n")
    for i, ref in enumerate(opts.ref_files):
        pcn = float(np.float32(readstats.reads_matched_per_db[i])
                    / np.float32(total)) * 100 if total else 0.0
        s.append(f"    {ref}\t\t{pcn:.2f}\n")

    if timestamp is None:
        timestamp = time.ctime()
    s.append(f"\n {timestamp}\n\n")
    return "".join(s)


def write_summary(opts: RunOptions, refstats: Refstats,
                  readstats: Readstats, total_otu: int = 0) -> str:
    path = opts.aligned_pfx + ".log"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = summary_text(opts, refstats, readstats, total_otu)
    with open(path, "w") as f:
        f.write(text)
    return path
