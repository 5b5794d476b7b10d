"""Run options (Runopts equivalent, options.hpp:459-717).

Defaults mirror options.hpp:495-587 and the validate() fixups
(options.cpp:1684 evalue=1, :1735 edges=4).  The CLI front end (cli.py)
maps the reference's 56 option names onto this structure and applies the
same cross-validation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class RunOptions:
    # inputs
    ref_files: List[str] = field(default_factory=list)
    reads_files: List[str] = field(default_factory=list)
    workdir: str = ""
    kvdb_dir: str = ""      # derived: workdir/kvdb
    idx_dir: str = ""       # derived: workdir/idx
    readb_dir: str = ""     # derived: workdir/readb
    aligned_pfx: str = ""   # default workdir/out/aligned
    other_pfx: str = ""     # default workdir/out/other ('--other')

    # alignment control (options.hpp:495-499)
    is_best: bool = True
    is_min_lis: bool = False
    is_num_alignments: bool = False
    is_full_search: bool = False
    # TPU-native extension: run the d<=1 seed probe on device
    # (ops/seed_search.py) instead of the host C++ kernel
    device_probe: bool = False
    is_forward: bool = False
    is_reverse: bool = False
    num_alignments: int = 1
    num_seeds: int = 2
    min_lis: int = 2
    edges: int = 4
    is_as_percent: bool = False

    # scoring (options.hpp:571-576)
    match: int = 2
    mismatch: int = -3
    gap_open: int = 5
    gap_ext: int = 2
    score_n: int = 0
    evalue: float = 1.0

    # OTU / denovo (options.hpp:578-580)
    min_id: float = -1.0
    min_cov: float = -1.0
    is_otu_map: bool = False
    is_denovo: bool = False

    # output control (options.hpp:503-517)
    is_paired: bool = False
    is_paired_in: bool = False
    is_paired_out: bool = False
    is_out2: bool = False
    is_sout: bool = False
    is_sam: bool = False
    is_SQ: bool = False
    is_blast: bool = False
    blast_format: str = "tabular"       # 'regular' | 'tabular'
    blastops: List[str] = field(default_factory=list)
    is_fastx: bool = False
    is_other: bool = False
    is_print_all_reads: bool = False
    zip_out: int = -1                    # -1 auto / 0 flat / 1 gzip

    # indexing (options.hpp:584-587)
    max_file_size: float = 3072.0
    seed_win_len: int = 18
    interval: int = 1
    max_pos: int = 10000

    # misc
    num_proc_thread: int = 2
    minoccur: int = 0
    is_paired_files_interleaved: bool = False   # single file w/ interleaved
    task: int = 4                        # --task 0..4 ('all' default)
    dbg_level: int = 0
    is_verbose: bool = False
    max_read_len: int = 30000
    is_pid: bool = False
    cmdline: str = ""
    findex: int = 2      # --index: 0 don't build, 1 index only, 2 auto
    is_cmd: bool = False  # --cmd interactive session

    # passes / skiplengths (one triple per index; 0 = use defaults)
    skiplengths: List[List[int]] = field(default_factory=list)

    # parity hook: list of (lambda, K) per reference DB, or None
    gumbel_override: Optional[List[Optional[Tuple[float, float]]]] = None

    def finalize(self) -> "RunOptions":
        """Derive directories and apply the default fixups
        (Runopts::validate, options.cpp:1660-1760)."""
        # input files must exist and be non-empty (Runopts::opt_reads /
        # opt_ref existence checks, options.cpp:123-183; an empty file
        # would otherwise surface as a parser traceback deep in the
        # feed)
        for kind, paths in (("reads", self.reads_files),
                            ("reference", self.ref_files)):
            for p in paths:
                if not os.path.exists(p):
                    raise SystemExit(
                        f"ERROR: {kind} file does not exist: {p}")
                if os.path.getsize(p) == 0:
                    raise SystemExit(
                        f"ERROR: {kind} file is empty: {p}")
        if self.workdir:
            self.idx_dir = self.idx_dir or os.path.join(self.workdir, "idx")
            self.kvdb_dir = self.kvdb_dir or os.path.join(self.workdir, "kvdb")
            out = os.path.join(self.workdir, "out")
            self.readb_dir = self.readb_dir or os.path.join(
                self.workdir, "readb")
            self.aligned_pfx = self.aligned_pfx or os.path.join(
                out, "aligned")
            if self.is_other and not self.other_pfx:
                self.other_pfx = os.path.join(out, "other")
        if self.evalue < 0:
            self.evalue = 1.0
        if self.edges < 0:
            self.edges = 4
        if len(self.reads_files) == 2:
            self.is_paired = True
        if not self.skiplengths:
            self.skiplengths = [[0, 0, 0] for _ in self.ref_files]
        elif len(self.skiplengths) == 1 and len(self.ref_files) > 1:
            # one --passes triple applies to every database (the
            # DOCUMENTED semantics; the reference's own opt_passes is
            # broken -- options.cpp:724 emplace_back(int) builds
            # zero-filled vectors that refstats.cpp:159 then overwrites
            # with defaults, so its --passes silently does nothing)
            self.skiplengths = [list(self.skiplengths[0])
                                for _ in self.ref_files]
        for sl in self.skiplengths:
            if sl[0] == 0 or sl[1] == 0 or sl[2] == 0:
                sl[0] = self.seed_win_len
                sl[1] = self.seed_win_len // 2
                sl[2] = 3
        return self
