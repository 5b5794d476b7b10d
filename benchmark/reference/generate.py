"""Seeded synthetic rRNA databases and sample jobs, from parameter files.

A configuration's database is a 16S-like FASTA in families (members a
few percent apart), made from its own ``db_seed``.  A traffic mix is a
JSON file of parameters that ``make_job`` reads: reads per job, the rRNA
share, the length distribution and the error model of the rRNA reads.
Every job of every seed has the same rRNA count, and the rRNA and the
other reads each the same multiset of lengths (the distribution's
quantiles; an rRNA read is at most its member's length); the seed
decides the order, the members cut from, the positions and the errors.
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from typing import List

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
QUAL = np.frombuffer(b"F:,#", np.uint8)     # binned Illumina-style scores
QUAL_P = (0.85, 0.10, 0.04, 0.01)


@dataclass
class Database:
    names: List[str]
    seqs: List[np.ndarray]          # codes 0..3 per member

    @property
    def total_len(self) -> int:
        return int(sum(len(s) for s in self.seqs))


def make_db(spec: dict) -> Database:
    """``spec``: n_seqs, n_families, len_range, divergence, db_seed.
    Each member is a window of its family's base with divergence/2 of
    its positions redrawn, so two members are about ``divergence``
    apart."""
    rng = np.random.default_rng(int(spec["db_seed"]))
    lo, hi = spec["len_range"]
    nf = int(spec["n_families"])
    bases = rng.integers(0, 4, (nf, hi + 200), dtype=np.uint8)
    names, seqs = [], []
    for i in range(int(spec["n_seqs"])):
        fam = i % nf
        ln = int(rng.integers(lo, hi + 1))
        off = int(rng.integers(0, 200))
        s = bases[fam, off:off + ln].copy()
        pos = rng.choice(ln, size=int(ln * spec["divergence"] / 2),
                         replace=False)
        s[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        names.append(f"fam{fam}_{i}")
        seqs.append(s)
    return Database(names, seqs)


def write_fasta(db: Database, path: str) -> None:
    with open(path, "wb") as f:
        for name, s in zip(db.names, db.seqs):
            f.write(b">" + name.encode() + b" synthetic 16S-like member\n"
                    + ACGT[s].tobytes() + b"\n")


def read_fasta(path: str) -> Database:
    """The plain reader the judge uses on the database file."""
    names, seqs = [], []
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    with open(path, "rb") as f:
        data = f.read()
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        names.append(head.split()[0].decode())
        seqs.append(lut[np.frombuffer(body.replace(b"\n", b""), np.uint8)])
    return Database(names, seqs)


def _quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's evenly spaced quantiles."""
    kind = spec["kind"]
    u = (np.arange(n) + 0.5) / n
    if kind == "mix":
        out, at = np.empty(n, np.int64), 0
        parts = spec["parts"]
        for k, part in enumerate(parts):
            m = n - at if k == len(parts) - 1 else int(round(part["share"]
                                                             * n))
            lo, hi = part["len"]
            v = (np.arange(m) + 0.5) / max(m, 1)
            out[at:at + m] = lo + np.floor(v * (hi - lo + 1)).astype(np.int64)
            at += m
        return out
    if kind == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.round(v), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def _revcomp(s: np.ndarray) -> np.ndarray:
    return (3 - s)[::-1]


def _indel(rng, s: np.ndarray, model: dict) -> np.ndarray:
    a, b = model["indel_len"]
    k = int(rng.integers(a, b + 1))
    at = int(rng.integers(1, len(s) - k - 1))
    if rng.random() < 0.5:
        return np.concatenate([s[:at], s[at + k:]])
    return np.concatenate([s[:at], rng.integers(0, 4, k, dtype=np.uint8),
                           s[at:]])


def _per_base_errors(rng, s: np.ndarray, model: dict) -> np.ndarray:
    """Independent per-base errors at ``error_rate``, split into
    substitutions, insertions and deletions by ``sub_share`` and
    ``ins_share``."""
    out = s.copy()
    for k in rng.random(int(rng.binomial(len(s), model["error_rate"]))):
        at = int(rng.integers(1, len(out) - 1))
        if k < model["sub_share"]:
            out[at] = (out[at] + rng.integers(1, 4)) % 4
        elif k < model["sub_share"] + model["ins_share"]:
            out = np.insert(out, at, rng.integers(0, 4))
        else:
            out = np.delete(out, at)
    return out.astype(np.uint8)


@dataclass
class Job:
    ids: List[bytes]
    seqs: List[np.ndarray]          # codes 0..3
    is_rrna: np.ndarray             # bool, from the generator's own truth


def make_job(db: Database, traffic: dict, seed: int, job: int,
             n_reads: int = 0) -> Job:
    """Job ``job`` of the pool that ``seed`` draws: ``n_reads`` reads
    (the traffic's ``reads_per_job`` by default).  rRNA reads are cut
    from a member (at most its length), take the error model
    ``rrna_errors`` (``subs`` substitutions and an indel with
    probability ``indel_p``, or per-base ``error_rate``), and half are
    reverse-complemented; the rest are uniform random sequence."""
    n = int(n_reads or traffic["reads_per_job"])
    rng = np.random.default_rng([int(seed) % (1 << 63), int(job)])
    n_r = int(round(n * traffic["rrna_share"]))
    is_rrna = np.zeros(n, bool)
    is_rrna[rng.permutation(n)[:n_r]] = True
    lens = np.empty(n, np.int64)
    lens[is_rrna] = rng.permutation(_quantiles(traffic["lengths"], n_r))
    lens[~is_rrna] = rng.permutation(_quantiles(traffic["lengths"],
                                                n - n_r))
    ridx = np.flatnonzero(is_rrna)
    mlen = np.array([len(s) for s in db.seqs])
    mstart = np.concatenate([[0], np.cumsum(mlen)[:-1]])
    dbcat = np.concatenate(db.seqs)
    members = rng.integers(0, len(db.seqs), n_r)
    L = np.minimum(lens[ridx], mlen[members])
    off = (rng.random(n_r) * (mlen[members] - L + 1)).astype(np.int64)
    width = int(L.max()) if n_r else 1
    at = (mstart[members] + off)[:, None] + np.arange(width)[None, :]
    cut = dbcat[np.minimum(at, len(dbcat) - 1)]
    model = traffic["rrna_errors"]
    per_base = "error_rate" in model
    if not per_base and n_r:
        lo, hi = model["subs"]
        k = rng.integers(lo, hi + 1, n_r)
        pos = (rng.random((n_r, max(hi, 1))) * L[:, None]).astype(np.int64)
        hit = np.arange(pos.shape[1])[None, :] < k[:, None]
        rows = np.repeat(np.arange(n_r), hit.sum(1))
        cols = pos[hit]
        cut[rows, cols] = (cut[rows, cols]
                           + rng.integers(1, 4, len(rows))) % 4
    indel = rng.random(n_r) < model.get("indel_p", 0.0)
    flip = rng.random(n_r) < 0.5
    noise = rng.integers(0, 4, int(lens[~is_rrna].sum()), dtype=np.uint8)
    seqs, r, at = [], 0, 0
    for i in range(n):
        if is_rrna[i]:
            s = cut[r, :L[r]]
            if per_base:
                s = _per_base_errors(rng, s, model)
            elif indel[r]:
                s = _indel(rng, s, model)
            seqs.append(_revcomp(s) if flip[r] else s)
            r += 1
        else:
            seqs.append(noise[at:at + lens[i]])
            at += lens[i]
    ids = [b"j%d_r%d" % (job, i) for i in range(n)]
    return Job(ids, seqs, is_rrna)


def fastq_bytes(job: Job, seed: int, jobnum: int) -> bytes:
    """The job as FASTQ text; quality strings drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), int(jobnum), 1])
    lens = np.array([len(s) for s in job.seqs])
    qual = QUAL[rng.choice(4, size=int(lens.sum()), p=QUAL_P)].tobytes()
    seq = ACGT[np.concatenate(job.seqs)].tobytes()
    out, at = [], 0
    for rid, ln in zip(job.ids, lens.tolist()):
        out.append(b"@%s\n%s\n+\n%s\n" % (rid, seq[at:at + ln],
                                          qual[at:at + ln]))
        at += ln
    return b"".join(out)


def write_job(path: str, data: bytes) -> None:
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(data)
