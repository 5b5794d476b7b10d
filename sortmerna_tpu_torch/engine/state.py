"""Persistent run state: the KVDB equivalent (kvdb.cpp + read.cpp blobs).

The reference checkpoints per-read alignment state into RocksDB so that
(a) interrupted runs resume skipping finished reads (processor.cpp:117-126)
and (b) the align / stats / report tasks can run as separate processes
over the same workdir (--task 0..4, options.cpp:982-1000).

Here the same capability is a compact binary state file per workdir:
 * one record per read with alignments (reads without state are absent,
   mirroring kvdb.get() == '' for unseen reads)
 * a run-level Readstats record keyed by the hash of the read file names
   (readstats.cpp:82-91)

The serialization is numpy-based (flat arrays) rather than per-read
pickles so that 100M-read state remains tractable.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Dict, List, Optional

from .candidates import Readstats
from .read import Alignment, ReadState


def readfiles_key(reads_files: List[str]) -> str:
    """Stable key from read file names (readstats.cpp:82-91 semantics)."""
    h = hashlib.sha1()
    for p in reads_files:
        h.update(os.path.basename(p).encode())
    return h.hexdigest()[:16]


class StateDB:
    def __init__(self, kvdb_dir: str):
        self.dir = kvdb_dir
        os.makedirs(kvdb_dir, exist_ok=True)

    def _states_path(self) -> str:
        return os.path.join(self.dir, "read_states.bin")

    def _stats_path(self, key: str) -> str:
        return os.path.join(self.dir, f"readstats_{key}.json")

    def is_empty(self) -> bool:
        return not os.path.exists(self._states_path())

    def clear(self) -> None:
        for f in (self._states_path(),):
            if os.path.exists(f):
                os.remove(f)
        for f in os.listdir(self.dir):
            if f.startswith("readstats_"):
                os.remove(os.path.join(self.dir, f))

    # -- read states -----------------------------------------------------

    def save_states(self, ids: List[str], states: List[ReadState]) -> None:
        recs = {}
        for rid, st in zip(ids, states):
            if not st.alignments and not st.is_hit and not st.is_done \
                    and st.hit_seeds == 0:
                continue    # reference only stores reads with alignments
            recs[rid] = st
        with open(self._states_path(), "wb") as f:
            pickle.dump(recs, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load_states(self) -> Dict[str, ReadState]:
        if self.is_empty():
            return {}
        with open(self._states_path(), "rb") as f:
            return pickle.load(f)

    # -- run stats -------------------------------------------------------

    def save_readstats(self, key: str, rs: Readstats,
                       extra: Optional[dict] = None) -> None:
        d = dict(rs.__dict__)
        if extra:
            d.update(extra)
        with open(self._stats_path(key), "w") as f:
            json.dump(d, f)

    def load_readstats(self, key: str) -> Optional[dict]:
        p = self._stats_path(key)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)


class AlignJournal:
    """Incremental align checkpoint: one record per completed
    (index, part, batch) unit, appended crash-safely.

    The reference persists each read's state to RocksDB right after
    processing it (processor.cpp:154) so a restarted align skips
    restored is_done reads (processor.cpp:117-126).  Here the unit of
    work is a batch sweep of one index part; each record carries the
    full post-unit state of that batch slice plus a Readstats snapshot,
    so a SIGKILLed run resumes at the last completed unit with
    byte-identical final outputs.

    Record layout: MAGIC u32 | payload_len u64 | crc32 u32 | payload
    (pickle).  A torn tail record (crash mid-write) fails the length or
    CRC check and is dropped.
    """

    MAGIC = 0x534D524A  # "SMRJ"

    def __init__(self, kvdb_dir: str):
        self.path = os.path.join(kvdb_dir, "align_journal.bin")

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def remove(self) -> None:
        if self.exists():
            os.remove(self.path)

    def _write(self, rec: dict) -> None:
        import zlib
        payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
        hdr = self.MAGIC.to_bytes(4, "little") \
            + len(payload).to_bytes(8, "little") \
            + zlib.crc32(payload).to_bytes(4, "little")
        with open(self.path, "ab") as f:
            f.write(hdr + payload)
            f.flush()
            os.fsync(f.fileno())

    def begin(self, batch_size: int, n_reads: int) -> None:
        """Write the run-shape meta record (first record of a fresh
        journal).  A resumed run must reuse the recorded batch_size so
        unit keys line up."""
        if not self.exists():
            self._write({"meta": {"batch_size": batch_size,
                                  "n_reads": n_reads}})

    def meta(self) -> Optional[dict]:
        for rec in self.scan():
            return rec.get("meta")
        return None

    def append(self, idx_num: int, part_num: int, b0: int,
               states: List[ReadState], readstats: Readstats) -> None:
        self._write(
            {"idx": idx_num, "part": part_num, "b0": b0,
             "states": states, "readstats": dict(readstats.__dict__)})

    def scan(self):
        """Yield journal records in order, stopping at a torn tail."""
        import zlib
        if not self.exists():
            return
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(16)
                if len(hdr) < 16:
                    return
                if int.from_bytes(hdr[:4], "little") != self.MAGIC:
                    return
                n = int.from_bytes(hdr[4:12], "little")
                crc = int.from_bytes(hdr[12:16], "little")
                if f.tell() + n > size:        # torn tail record
                    return
                payload = f.read(n)
                if len(payload) < n or zlib.crc32(payload) != crc:
                    return
                yield pickle.loads(payload)

    def restore(self, states: List[ReadState], readstats: Readstats
                ) -> set:
        """Apply all intact records to (states, readstats) in place.

        Returns the set of completed (idx, part, b0) units.  Later
        records for the same batch overwrite earlier ones (states are
        cumulative across parts); the readstats snapshot of the final
        record is authoritative (the unit loop is sequential)."""
        done = set()
        last_stats = None
        for rec in self.scan():
            if "meta" in rec:
                continue
            done.add((rec["idx"], rec["part"], rec["b0"]))
            b0 = rec["b0"]
            states[b0:b0 + len(rec["states"])] = rec["states"]
            last_stats = rec["readstats"]
        if last_stats is not None:
            for k, v in last_stats.items():
                if hasattr(readstats, k):
                    setattr(readstats, k, v)
        return done
