"""FASTX aligned/other read output with the paired routing matrix.

Ports ReportFastx/ReportFxOther/ReportFxBase (report_fastx.cpp:56-147,
report_fx_other.cpp:55-125, report_fx_base.cpp:55-171):

* 1/2/4-way output fan-out from --out2 / --sout
* routing by is_hit with --paired_in / --paired_out overrides
* file naming 'aligned{_paired|_singleton}{_fwd|_rev}.{fa,fq}[.gz]'
  (the reference's per-thread '_N' split suffix disappears after its merge
  step, report.cpp:56-96; this engine writes the merged layout directly)
* records are echoed verbatim (original header line + sequence).
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional

from ..engine.read import ReadSeq, ReadState
from ..options import RunOptions


def _names(pfx: str, num_out: int, opts: RunOptions,
           orig_fastq: List[bool], zip_out: bool) -> List[str]:
    names = []
    orig_i = 0
    for j in range(num_out):
        sfx1 = ""
        sfx2 = ""
        if num_out == 4:
            sfx1 = ["_paired_fwd", "_paired_rev",
                    "_singleton_fwd", "_singleton_rev"][j]
        elif num_out == 2:
            if opts.is_out2:
                sfx2 = "_fwd" if j == 0 else "_rev"
            else:
                sfx1 = "_paired" if j == 0 else "_singleton"
        ext = ".fq" if orig_fastq[orig_i] else ".fa"
        gz = ".gz" if zip_out else ""
        names.append(pfx + sfx1 + sfx2 + ext + gz)
        if len(orig_fastq) == 2:
            orig_i ^= 1
    return names


def num_out_files(opts: RunOptions) -> int:
    if opts.is_out2 and opts.is_sout:
        return 4
    if opts.is_out2 or opts.is_sout:
        return 2
    return 1


def validate_out_type(opts: RunOptions) -> None:
    """Combination rules (report_fx_base.cpp:106-163)."""
    if opts.is_paired_in and opts.is_paired_out:
        raise ValueError("paired_in and paired_out cannot be used together")
    if opts.is_sout and (opts.is_paired_in or opts.is_paired_out):
        raise ValueError(
            "'sout' cannot be used with 'paired_in' or 'paired_out'")


class FastxReport:
    """Writer for either the aligned ('fastx') or the 'other' stream."""

    def __init__(self, opts: RunOptions, pfx: str, orig_fastq: List[bool],
                 other: bool = False):
        validate_out_type(opts)
        self.opts = opts
        self.other = other
        self.num_out = num_out_files(opts)
        zip_out = opts.zip_out == 1
        self.paths = _names(pfx, self.num_out, opts, orig_fastq, zip_out)
        op = (lambda p: gzip.open(p, "wt")) if zip_out else \
            (lambda p: open(p, "wt"))
        for p in self.paths:
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        self.files = [op(p) for p in self.paths]

    @staticmethod
    def _record(read: ReadSeq) -> str:
        mark = "@" if read.is_fastq else ">"
        s = f"{mark}{read.header}\n{read.sequence}\n"
        if read.is_fastq:
            s += f"+\n{read.quality}\n"
        return s

    def append(self, reads: List[ReadSeq], states: List[ReadState]) -> None:
        opts = self.opts
        hit = [s.is_hit for s in states]
        if opts.is_paired:
            if not self.other and not hit[0] and not hit[1]:
                return    # neither aligned (report_fastx.cpp:71-72)
            if self.other and hit[0] and hit[1]:
                return    # both aligned (report_fx_other.cpp:53-54)
            for i in range(len(reads)):
                idx = self._route(i, hit)
                if idx is None:
                    continue
                if idx == -1:   # 'break' semantics: stop both reads
                    return
                self.files[idx].write(self._record(reads[i]))
        else:
            want = (not hit[0]) if self.other else hit[0]
            if want:
                self.files[0].write(self._record(reads[0]))

    def _route(self, i: int, hit: List[bool]) -> Optional[int]:
        """File index for read i of a pair; None=skip, -1=skip both."""
        opts = self.opts
        if not self.other:
            # ReportFastx::append (report_fastx.cpp:75-127)
            if self.num_out == 1:
                if opts.is_paired_out:
                    return 0 if (hit[0] and hit[1]) else None
                if opts.is_paired_in or hit[i]:
                    return 0
                return None
            if self.num_out == 2:
                if opts.is_out2:
                    if opts.is_paired_out:
                        return i if (hit[0] and hit[1]) else -1
                    if opts.is_paired_in or hit[i]:
                        return i
                    return None
                # sout
                if hit[0] and hit[1]:
                    return 0
                if hit[i]:
                    return 1
                return None
            # num_out == 4
            if hit[0] and hit[1]:
                return i
            if hit[i]:
                return i + 2
            return None
        else:
            # ReportFxOther::append (report_fx_other.cpp:55-105)
            if self.num_out == 1:
                if opts.is_paired_in:
                    return None if (hit[0] or hit[1]) else 0
                if opts.is_paired_out or not hit[i]:
                    return 0
                return None
            if self.num_out == 2:
                if opts.is_out2:
                    if opts.is_paired_in:
                        return -1 if (hit[0] or hit[1]) else i
                    if opts.is_paired_out or not hit[i]:
                        return i
                    return None
                if not hit[0] and not hit[1]:
                    return 0
                if not hit[i]:
                    return 1
                return None
            if not hit[0] and not hit[1]:
                return i
            if not hit[i]:
                return i + 2
            return None

    def close(self) -> None:
        for f in self.files:
            f.close()


def is_denovo_read(s: ReadState) -> bool:
    """output.cpp:133-143 / report_denovo.cpp predicate."""
    return (s.n_denovo > 0 and s.c_yid_ycov == 0
            and s.n_yid_ncov == 0 and s.n_nid_ycov == 0)


class DenovoReport(FastxReport):
    """Fasta/q of reads aligned by E-value but failing both %id and %cov
    (report_denovo.cpp:57-137).  The caller gates on the is_denovo_read
    predicate (output.cpp:133-143); pair routing below replaces is_hit by
    that predicate, with the reference's exact asymmetries."""

    def append_denovo(self, reads: List[ReadSeq],
                      states: List[ReadState]) -> None:
        opts = self.opts
        dn = [is_denovo_read(s) for s in states]
        if not opts.is_paired:
            self.files[0].write(self._record(reads[0]))
            return
        both = dn[0] and dn[1]
        idx = 0   # NOT reset per read: the out2 branch relies on the stale
        # value when neither condition holds (report_denovo.cpp:61-74 has
        # no else-continue in the out2 case) -- reproduced bug-compatibly.
        for i in range(len(reads)):
            if self.num_out == 1:
                if opts.is_paired_in or dn[i]:
                    idx = 0
                else:
                    continue
            elif self.num_out == 2:
                if opts.is_out2:
                    if opts.is_paired_out and not both:
                        return
                    elif opts.is_paired_in or dn[i]:
                        idx = i
                    # else: stale idx, still written
                else:   # sout
                    if both:
                        idx = 0
                    elif dn[i]:
                        idx = 1
                    else:
                        continue
            else:       # num_out == 4
                if both:
                    idx = i
                elif dn[i]:
                    idx = i + 2
                else:
                    continue
            self.files[idx].write(self._record(reads[i]))
