"""Seeded synthetic rRNA databases and sample jobs, from parameter files.

A configuration's database is a FASTA in families (members a few
percent apart), made from its own ``db_seed``; or a list of such
databases, each named, passed to the program as one ``-ref`` each in
the list's order.  A traffic mix is a JSON file of parameters that
``make_job`` (single-end) or ``make_pairs`` (with a ``paired`` entry)
reads: reads or pairs per job, the rRNA share, the length distributions
and the error model of the rRNA reads.  Every job of every seed has the
same rRNA count, and the rRNA and the other reads each the same
multiset of lengths (the distribution's quantiles; an rRNA read is at
most its member's length); the seed decides the order, the members cut
from, the positions and the errors.
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from typing import List, Tuple

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


SINGLE = "db"           # the file stem of a configuration's only database


def make_db(spec: dict, prefix: str = "") -> Database:
    """``spec``: n_seqs, n_families, len_range, divergence, db_seed, and
    optionally gc, the share of G and C (uniform bases without it).
    Each member is a window of its family's base with divergence/2 of
    its positions redrawn, so two members are about ``divergence``
    apart.  Members are named ``<prefix>fam<f>_<i>``."""
    rng = np.random.default_rng(int(spec["db_seed"]))
    gc = spec.get("gc")
    p = None if gc is None else [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def bases_of(size):
        if p is None:
            return rng.integers(0, 4, size, dtype=np.uint8)
        return rng.choice(4, size=size, p=p).astype(np.uint8)

    lo, hi = spec["len_range"]
    nf = int(spec["n_families"])
    bases = bases_of((nf, hi + 200))
    names, seqs = [], []
    for i in range(int(spec["n_seqs"])):
        fam = i % nf
        ln = int(rng.integers(lo, hi + 1))
        off = int(rng.integers(0, 200))
        s = bases[fam, off:off + ln].copy()
        pos = rng.choice(ln, size=int(ln * spec["divergence"] / 2),
                         replace=False)
        s[pos] = bases_of(len(pos))
        names.append(f"{prefix}fam{fam}_{i}")
        seqs.append(s)
    return Database(names, seqs)


def database_names(spec) -> List[str]:
    """The names of a configuration's databases, in ``-ref`` order: a
    single spec is the one database ``SINGLE``; a list holds specs that
    each add a ``name``."""
    return [SINGLE] if isinstance(spec, dict) else [d["name"] for d in spec]


def make_databases(spec) -> List[Database]:
    """A configuration's databases, in ``-ref`` order.  A single spec
    gives members named as ``make_db`` names them; in a list each name,
    with ``_``, prefixes its members' names, so that names stay unique
    across databases."""
    if isinstance(spec, dict):
        return [make_db(spec)]
    return [make_db(d, d["name"] + "_") for d in spec]


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


def _shares(counts: np.ndarray, n: int) -> np.ndarray:
    """``n`` split in proportion to ``counts`` by largest remainders."""
    want = n * np.asarray(counts, np.float64) / np.sum(counts)
    out = np.floor(want).astype(np.int64)
    out[np.argsort(out - want, kind="stable")[:n - int(out.sum())]] += 1
    return out


def _rrna_errors(rng, s: np.ndarray, model: dict) -> np.ndarray:
    """``rrna_errors`` on one read, as ``make_job`` lays them on its
    reads all at once: per-base errors, or ``subs`` substitutions at
    positions drawn with replacement (one drawn twice changes once) and
    an indel with probability ``indel_p``.  The model is the same; the
    draws come in another order, since ``make_job``'s order fixes its
    bytes."""
    if "error_rate" in model:
        return _per_base_errors(rng, s, model)
    s = s.copy()
    lo, hi = model["subs"]
    pos = (rng.random(int(rng.integers(lo, hi + 1))) * len(s)).astype(
        np.int64)
    s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
    if rng.random() < model.get("indel_p", 0.0):
        s = _indel(rng, s, model)
    return s.astype(np.uint8)


@dataclass
class Pairs:
    mates: Tuple[Job, Job]          # the two files' reads, pair i at i
    is_rrna: np.ndarray             # bool per pair
    db: np.ndarray                  # its database's index; -1: not rRNA


def make_pairs(dbs: List[Database], names: List[str], traffic: dict,
               seed: int, job: int, n_pairs: int = 0) -> Pairs:
    """Job ``job`` of the pool that ``seed`` draws, paired-end:
    ``n_pairs`` pairs (the traffic's ``reads_per_job`` by default).
    Each fragment's length is drawn from ``paired.insert``.  rRNA
    fragments are cut from a member (at most its length) of a database
    chosen by the shares of ``rrna_mix`` (by database name; without it,
    in proportion to each database's nt); the rest are uniform random
    sequence.  A whole rRNA fragment is reverse-complemented with
    probability 1/2.  Mate 1 is the fragment's first ``lengths`` bases,
    mate 2 the reverse complement of its last, each at most the
    fragment; ``rrna_errors`` applies to each rRNA mate on its own.
    Every seed gives each database the same count of fragments."""
    n = int(n_pairs or traffic["reads_per_job"])
    rng = np.random.default_rng([int(seed) % (1 << 63), int(job)])
    n_r = int(round(n * traffic["rrna_share"]))
    is_rrna = np.zeros(n, bool)
    is_rrna[rng.permutation(n)[:n_r]] = True
    ins = dict(kind="mix", parts=[dict(share=1.0,
                                       len=traffic["paired"]["insert"])])
    frag = np.empty(n, np.int64)
    frag[is_rrna] = rng.permutation(_quantiles(ins, n_r))
    frag[~is_rrna] = rng.permutation(_quantiles(ins, n - n_r))
    lens = [rng.permutation(_quantiles(traffic["lengths"], n))
            for _ in range(2)]
    mix = traffic.get("rrna_mix")
    if mix and set(mix) - set(names):
        raise ValueError(f"rrna_mix names no database: "
                         f"{sorted(set(mix) - set(names))}")
    weight = [mix.get(nm, 0.0) for nm in names] if mix else \
        [d.total_len for d in dbs]
    src = np.full(n, -1, np.int64)
    src[is_rrna] = rng.permutation(np.repeat(np.arange(len(dbs)),
                                             _shares(weight, n_r)))
    model = traffic["rrna_errors"]
    ids = [[b"j%d_r%d/%d" % (job, i, m) for i in range(n)] for m in (1, 2)]
    seqs: List[List[np.ndarray]] = [[], []]
    for i in range(n):
        if src[i] >= 0:
            db = dbs[src[i]]
            member = db.seqs[int(rng.integers(0, len(db.seqs)))]
            L = min(int(frag[i]), len(member))
            off = int(rng.integers(0, len(member) - L + 1))
            f = member[off:off + L]
            if rng.random() < 0.5:
                f = _revcomp(f)
        else:
            f = rng.integers(0, 4, int(frag[i]), dtype=np.uint8)
        ends = (f[:min(int(lens[0][i]), len(f))],
                _revcomp(f[len(f) - min(int(lens[1][i]), len(f)):]))
        for m in (0, 1):
            seqs[m].append(_rrna_errors(rng, ends[m], model)
                           if src[i] >= 0 else ends[m])
    return Pairs(tuple(Job(ids[m], seqs[m], is_rrna) for m in (0, 1)),
                 is_rrna, src)


def fastq_bytes(job: Job, seed: int, jobnum: int, stream: int = 1) -> bytes:
    """The job as FASTQ text; quality strings drawn from the seed
    (``stream`` 2 for a pair's second file)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), int(jobnum),
                                 int(stream)])
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
