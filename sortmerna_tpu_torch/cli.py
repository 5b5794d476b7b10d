"""Command-line interface: the reference's 56-option surface
(options.hpp:61-123 names, options.cpp handlers & validation).

The SW waves run on the device named by ``SMR_TORCH_DEVICE`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions).  Without a
GPU the default device raises instead of running on the CPU.

Single or double dash accepted (README.md:130); multi-value options by
repetition (--ref x N, --reads x 2); BOOL options take an optional
true/false token.  Workdir layout: workdir/{idx,kvdb,out,readb}
(options.hpp:601-604).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from .options import RunOptions

VERSION = "5.0.0-torch.1"

BOOL_OPTS = {
    "fastx", "sam", "SQ", "log", "no-best", "print_all_reads", "paired",
    "paired_in", "paired_out", "out2", "sout", "de_novo_otu", "otu_map",
    "full_search", "device_probe", "pid", "F", "R", "v", "h", "version",
    "cmd",
    "dbg_put_db", "align", "filter", "score_split", "other",
}
VALUE_OPTS = {
    "ref", "reads", "aligned", "workdir", "kvdb", "idx-dir", "readb",
    "blast", "num_alignments", "min_lis", "match", "mismatch", "gap_open",
    "gap_ext", "a", "d", "e", "L", "m", "N", "id", "coverage", "passes",
    "edges", "num_seeds", "task", "threads", "thpp", "threp", "tmpdir",
    "interval", "max_pos", "readfeed", "zip-out", "index", "dbg-level",
    "max_read_len",
}
# 'other' may appear with or without a value (an output prefix)
MAYBE_VALUE_OPTS = {"other", "aligned"}


class CliError(SystemExit):
    pass


def parse_args(argv: List[str]) -> RunOptions:
    opts = RunOptions()
    opts.cmdline = " ".join(["sortmerna"] + argv)
    i = 0
    raw = {}

    def peek_val(i):
        if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
            return argv[i + 1]
        return None

    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise CliError(f"unexpected token: {tok}")
        name = tok.lstrip("-")
        if name in MAYBE_VALUE_OPTS:
            val = peek_val(i)
            if val is not None:
                i += 1
            _apply(opts, name, val, raw)
        elif name in BOOL_OPTS:
            val = peek_val(i)
            if val is not None and val.lower() in ("true", "false"):
                i += 1
                _apply(opts, name, val.lower(), raw)
            else:
                _apply(opts, name, None, raw)
        elif name in VALUE_OPTS:
            val = peek_val(i)
            if val is None:
                # value may legitimately start with '-' (e.g. --mismatch -3)
                if i + 1 < len(argv) and _is_number(argv[i + 1]):
                    val = argv[i + 1]
            if val is None:
                raise CliError(f"option '{tok}' requires a value")
            i += 1
            _apply(opts, name, val, raw)
        else:
            raise CliError(f"unknown option: {tok}")
        i += 1

    validate(opts, raw)
    return opts


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _apply(opts: RunOptions, name: str, val: Optional[str], raw: dict):
    raw.setdefault(name, []).append(val)
    b = val != "false"      # for BOOL opts: present (or 'true') => True
    if name == "ref":
        opts.ref_files.append(val)
    elif name == "reads":
        opts.reads_files.append(val)
    elif name == "workdir":
        opts.workdir = val
    elif name == "kvdb" or name == "d":
        opts.kvdb_dir = val
    elif name == "idx-dir":
        opts.idx_dir = val
    elif name == "readb":
        opts.readb_dir = val
    elif name == "aligned":
        if val:
            opts.aligned_pfx = val
    elif name == "other":
        opts.is_other = True
        if val:
            opts.other_pfx = val
    elif name == "fastx":
        opts.is_fastx = b
    elif name == "sam":
        opts.is_sam = b
    elif name == "SQ":
        opts.is_SQ = b
    elif name == "blast":
        opts.is_blast = True
        toks = val.split()
        if toks and toks[0] in ("0", "1"):
            opts.blast_format = "regular" if toks[0] == "0" else "tabular"
            opts.blastops = toks[1:]
        else:
            opts.blastops = toks
    elif name == "log":
        pass    # always generated (options.hpp:512 TODO note)
    elif name == "num_alignments":
        opts.num_alignments = int(val)
        opts.is_num_alignments = True
    elif name == "no-best":
        opts.is_best = not b
    elif name == "min_lis":
        opts.min_lis = int(val)
        opts.is_min_lis = True
    elif name == "print_all_reads":
        opts.is_print_all_reads = b
    elif name == "paired":
        opts.is_paired = b
        opts.is_paired_files_interleaved = b
    elif name == "paired_in":
        opts.is_paired_in = b
    elif name == "paired_out":
        opts.is_paired_out = b
    elif name == "out2":
        opts.is_out2 = b
    elif name == "sout":
        opts.is_sout = b
    elif name == "match":
        opts.match = int(val)
    elif name == "mismatch":
        opts.mismatch = int(val)
    elif name == "gap_open":
        opts.gap_open = int(val)
    elif name == "gap_ext":
        opts.gap_ext = int(val)
    elif name == "e":
        opts.evalue = float(val)
    elif name == "F":
        opts.is_forward = b
    elif name == "R":
        opts.is_reverse = b
    elif name == "L":
        # reference behavior (options.cpp opt_L): a positive even integer
        # in 8..26; anything else warns and keeps the default
        try:
            v = int(val)
        except ValueError:
            v = -1
        if v <= 0 or v % 2 == 1 or v < 8 or v > 26:
            print("WARNING: Option 'L' takes a Positive Even integer "
                  "between 8 and 26 inclusive e.g. 10, 12, 14, .. , 20. "
                  f"Provided value: {val}. "
                  f"Default will be used: {opts.seed_win_len}",
                  file=sys.stderr)
        else:
            opts.seed_win_len = v
    elif name == "m":
        opts.max_file_size = float(val)
    elif name == "N":
        opts.score_n = int(val)
    elif name == "v":
        opts.is_verbose = b
    elif name == "id":
        opts.min_id = float(val)
    elif name == "coverage":
        opts.min_cov = float(val)
    elif name == "de_novo_otu":
        opts.is_denovo = b
    elif name == "otu_map":
        opts.is_otu_map = b
    elif name == "passes":
        parts = [int(x) for x in val.replace(",", " ").split()]
        if len(parts) != 3:
            raise CliError("--passes requires 3 integers")
        opts.skiplengths = [list(parts)]
    elif name == "edges":
        v = val
        if v.endswith("%"):
            opts.is_as_percent = True
            v = v[:-1]
        opts.edges = int(v)
    elif name == "num_seeds":
        opts.num_seeds = int(val)
    elif name == "full_search":
        opts.is_full_search = b
    elif name == "device_probe":
        opts.device_probe = b
    elif name == "pid":
        opts.is_pid = b
    elif name == "task":
        t = int(val)
        if t < 0 or t > 4:
            raise CliError("-task accepts values 0..4")
        opts.task = t
    elif name in ("threads", "a"):
        opts.num_proc_thread = int(val)
    elif name == "index":
        v = int(val)
        if v not in (0, 1, 2):
            raise CliError("'--index' accepts 0 | 1 | 2")
        opts.findex = v
    elif name == "cmd":
        opts.is_cmd = b
    elif name in ("thpp", "threp", "tmpdir", "readfeed", "dbg_put_db",
                  "align", "filter", "score_split"):
        pass    # accepted for surface compatibility; no-ops here
    elif name == "zip-out":
        opts.zip_out = 1 if val in (None, "1", "true") else 0
    elif name == "interval":
        opts.interval = int(val)
    elif name == "max_pos":
        opts.max_pos = int(val)
    elif name == "dbg-level":
        opts.dbg_level = int(val)
    elif name == "max_read_len":
        opts.max_read_len = int(val)
    elif name == "h":
        print_help()
        raise SystemExit(0)
    elif name == "version":
        print(f"SortMeRNA-Torch version {VERSION}")
        raise SystemExit(0)


def validate(opts: RunOptions, raw: dict) -> None:
    """Cross-validation (Runopts::validate, options.cpp:1660+)."""
    if "h" in raw or "version" in raw:
        return
    if not opts.ref_files:
        raise CliError("Missing required option: --ref")
    if not opts.reads_files:
        raise CliError("Missing required option: --reads")
    if len(opts.reads_files) > 2:
        raise CliError("at most two read files can be specified")
    if not opts.workdir and not opts.aligned_pfx:
        home = os.path.expanduser("~")
        opts.workdir = os.path.join(home, "sortmerna", "run")
    if opts.gap_ext > opts.gap_open:
        raise CliError("--gap_ext must be <= --gap_open")
    if opts.is_paired_in and opts.is_paired_out:
        raise CliError(
            "'paired_in' and 'paired_out' cannot be used together")
    if opts.is_sout and (opts.is_paired_in or opts.is_paired_out):
        raise CliError(
            "'sout' cannot be used with 'paired_in' or 'paired_out'")
    if opts.is_otu_map and not opts.is_best:
        raise CliError("'otu_map' cannot be set with 'no-best'")
    if (opts.is_otu_map or opts.is_denovo):
        if opts.min_id < 0:
            opts.min_id = 0.97
        if opts.min_cov < 0:
            opts.min_cov = 0.97
    else:
        if opts.min_id < 0:
            opts.min_id = 0.0
        if opts.min_cov < 0:
            opts.min_cov = 0.0
    opts.finalize()


def print_help() -> None:
    print(__doc__)
    print("See the reference manual; all sortmerna 5.x options are "
          "accepted with identical names and defaults.")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if opts.is_cmd:
        from .engine.repl import CmdSession
        CmdSession(opts).run()
        return 0
    if opts.findex == 1:
        # index-only task (main.cpp:73-76)
        from .index.artifact import build_or_load
        for p in opts.ref_files:
            build_or_load(p, opts.idx_dir or None, opts.interval,
                          opts.max_pos, opts.max_file_size)
        print("Only performed indexing as 'index' = 1 was specified")
        return 0
    if int(os.environ.get("SMR_NPROCS", "0") or 0) > 1:
        # multi-host launch: one process per host with SMR_COORD /
        # SMR_NPROCS / SMR_PROC_ID set (parallel/dist.run_all_multihost)
        from .parallel.dist import run_all_multihost, shutdown_multihost
        try:
            run_all_multihost(
                opts, device=os.environ.get("SMR_TORCH_DEVICE", "cuda"))
        finally:
            shutdown_multihost()
        return 0
    from .engine.run import run_all
    run_all(opts, device=os.environ.get("SMR_TORCH_DEVICE", "cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
