"""Reads the comparison's numbers of sound runs, of the control (8-bit
saturating SW scores, ``faults.saturate8``) and of the planted faults,
at a cell's own size on the card, all in one process: one job a reading,
no warm-up.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> NAME@SEED...

NAME is ``sound`` or a ``faults.FAULTS`` or ``faults.PAIRED_FAULTS``
entry; each reading prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import run
import faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("readings", nargs="+")
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    spec["traffic"]["pool_jobs"] = 1
    for item in args.readings:
        name, seed = item.split("@")
        fault = None if name == "sound" else \
            {**faults.FAULTS, **faults.PAIRED_FAULTS}[name]
        try:
            res = run.run_cell(copy.deepcopy(spec), int(seed), 0.0, False,
                               fault=fault, warm_up=False)
            out = dict(correct=res["correct"], failed=res["failed"],
                       compared=res["compared"])
        except Exception as e:        # a crash fails, and reads nothing
            out = dict(correct=False, crashed=repr(e))
        print(json.dumps(dict(workload=args.workload, reading=name,
                              seed=int(seed), **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
