"""Interactive debug session (--cmd), the CmdSession equivalent
(cmd.cpp:63-321): inspect reads, k-mer index entries and references.

Commands:
  read --id=N                 show a read and its stored alignment state
  index --idx=I [--part=P] --kmer=SEQ18   look up an 18-mer in the index
  ref --idx=I [--part=P]      part reference counts
  exit | quit

The session prepares the run (reads, indexes, reference statistics) at
its first command and never aligns, so it touches no GPU: device state
(the SW backend, the device probe's tables) is made by an align only.
"""

from __future__ import annotations

import shlex
import sys

import numpy as np

from ..options import RunOptions


class CmdSession:
    def __init__(self, opts: RunOptions):
        self.opts = opts
        self._ctx = None

    def _ctx_lazy(self):
        if self._ctx is None:
            from .run import prepare
            self._ctx = prepare(self.opts)
        return self._ctx

    def run(self, stream=None) -> None:
        stream = stream or sys.stdin
        print("sortmerna-tpu interactive session. 'exit' to quit.")
        for line in stream:
            line = line.strip()
            if not line:
                continue
            if line in ("exit", "quit"):
                break
            try:
                self.dispatch(line)
            except Exception as e:  # REPL: report, keep going
                print(f"error: {e}")

    def dispatch(self, line: str) -> None:
        toks = shlex.split(line)
        cmd = toks[0]
        args = {}
        for t in toks[1:]:
            if t.startswith("--") and "=" in t:
                k, v = t[2:].split("=", 1)
                args[k] = v
        if cmd == "read":
            self.cmd_read(args)
        elif cmd == "index":
            self.cmd_index(args)
        elif cmd == "ref":
            self.cmd_ref(args)
        else:
            print(f"unknown command: {cmd}")

    def cmd_read(self, args) -> None:
        ctx = self._ctx_lazy()
        rid = args.get("id", "0_0")
        if "_" not in rid:
            rid = f"0_{rid}"
        for r in ctx.reads:
            if r.id == rid:
                print(f"id={r.id} len={len(r)} header={r.header}")
                print(r.sequence)
                return
        print(f"read {rid} not found")

    def cmd_index(self, args) -> None:
        ctx = self._ctx_lazy()
        idx = int(args.get("idx", 0))
        part_n = int(args.get("part", 0))
        part = ctx.indexes[idx].parts[part_n]
        kmer = args.get("kmer")
        if kmer is None:
            print(f"index {idx} part {part_n}: {part.num_ids} unique "
                  f"18-mers, {len(part.pos_seq)} positions")
            return
        from ..constants import NT_TABLE
        enc = NT_TABLE[np.frombuffer(kmer.upper().encode(), np.uint8)]
        if len(enc) != 18 or (enc > 3).any():
            print("need an 18-character ACGT k-mer")
            return
        packed = np.uint64(0)
        for c in enc:
            packed = (packed << np.uint64(2)) | np.uint64(c)
        pos = np.searchsorted(part.kmers18, packed)
        if pos < part.num_ids and part.kmers18[pos] == packed:
            s, e = int(part.pos_offsets[pos]), int(part.pos_offsets[pos + 1])
            print(f"id={pos} occurrences={e - s}")
            for j in range(s, min(e, s + 20)):
                print(f"  seq={part.pos_seq[j]} pos={part.pos_pos[j]}")
        else:
            print("18-mer not present in this part")

    def cmd_ref(self, args) -> None:
        ctx = self._ctx_lazy()
        idx = int(args.get("idx", 0))
        part_n = int(args.get("part", 0))
        part = ctx.indexes[idx].parts[part_n]
        print(f"index {idx} part {part_n}: sequences "
              f"{part.first_seq}..{part.first_seq + part.numseq_part - 1}")
