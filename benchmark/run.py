"""The benchmark of ``sortmerna_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell is a configuration (``configs/<name>.json``: the database, or a
list of databases, the CLI flags of the deployment) under a traffic mix
(``traffic/<name>.json``: the sample jobs, single-end or paired, and the
limits of the comparison), both named in ``BENCHMARK.json``.  The unit
of work is one sample job: one in-process call of
``sortmerna_tpu_torch.cli.main`` with every database as a ``-ref`` and
its own input file (or a pair's two) and workdir, as a user runs one
process per sample.  Jobs run back to back; the window ends at the
first job boundary at or after ``--seconds``.

Set-up (``setup_s``): torch and the port imported, the CUDA context,
the databases, their index and Gumbel cache found in ``.cache/<config>/``
(made on the first run in a checkout), this run's pool of job files
generated from the seed, and a warm-up run of the pool's first job
(timed apart as well, on standard error).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` turns
on the port's stage timers, clocks the ``run_all`` phases, counts the SW
kernel's bound at each fetch and profiles the window, and prints the
per-layer metrics, each computed by ``metrics/<name>.py``.  After the
window every job's outputs are judged against the plain reference
(``reference/judge.py``), with the reference's own Gumbel lambda and K
of each database (``reference/gumbel.py``, made on the first run and
kept in ``.cache/<config>/``); the numbers compared, each beside its
limit, are the last lines of standard error and the last key of the
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from reference import generate, gumbel, judge  # noqa: E402
from reference import roofline  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "sortmerna_tpu"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's workload entry, configuration, traffic mix and the
    per-layer metrics that apply to it, found by name."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return dict(
        cell=cell,
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(BENCH, "traffic",
                                       cell["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def load_reader(metric: str) -> Callable[[dict], Optional[float]]:
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


# ---------------------------------------------------------------------------
# memory


def host_probe_ms() -> float:
    """Milliseconds for a fixed piece of host work (sorting 2**20
    integers), logged beside the window to tell a slow host from a slow
    program."""
    import numpy as np
    x = np.random.default_rng(0).integers(0, 1 << 30, 1 << 20)
    t = time.perf_counter()
    np.sort(x)
    return (time.perf_counter() - t) * 1e3


def rusage_since(before) -> Dict[str, float]:
    """The process's CPU seconds, page faults and context switches since
    ``before``: what a job cost the host besides its wall time."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return {n: getattr(now, "ru_" + n) - getattr(before, "ru_" + n)
            for n in ("utime", "stime", "minflt", "majflt", "nvcsw",
                      "nivcsw")}


def reset_rss_peak() -> str:
    """Reset VmHWM to the current RSS; returns how the peak is read."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return "VmHWM, reset at the window's start"
    except OSError:
        return "ru_maxrss (VmHWM could not be reset)"


def rss_peak_bytes(how: str) -> int:
    if how.startswith("VmHWM"):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ---------------------------------------------------------------------------
# the database and the jobs


def ensure_databases(config: dict, cache: str) -> list:
    """The configuration's database files in ``cache``, in ``-ref``
    order (``generate.database_names``).  Their index and Gumbel cache
    are built by the port into ``cache/idx`` during the first run's
    warm-up job, after which ``ready`` is written; a run cut short
    before that leaves the whole cache to be made again."""
    spec = config["database"]
    paths = [os.path.join(cache, name + ".fasta")
             for name in generate.database_names(spec)]
    if not os.path.exists(os.path.join(cache, "ready")):
        shutil.rmtree(cache, ignore_errors=True)
        os.makedirs(cache)
        for db, path in zip(generate.make_databases(spec), paths):
            generate.write_fasta(db, path)
        log(f"{len(paths)} database(s) made into {cache}; the warm-up job "
            "builds their index")
    return paths


def gumbel_path(cache: str, db_path: str) -> str:
    """Where the reference's Gumbel law of a database is kept:
    ``ref_gumbel.json`` for a configuration's only database,
    ``ref_gumbel_<name>.json`` for each of a list."""
    stem = os.path.basename(db_path)[:-len(".fasta")]
    return os.path.join(cache, "ref_gumbel.json" if stem == generate.SINGLE
                        else f"ref_gumbel_{stem}.json")


def make_pool(dbs: list, names: list, traffic: dict, seed: int,
              tmp: str) -> list:
    """The run's job files from the seed: per job (its files, the
    generator's rRNA record per read or pair, its reads, its nt)."""
    pool = []
    for k in range(int(traffic["pool_jobs"])):
        if "paired" in traffic:
            got = generate.make_pairs(dbs, names, traffic, seed, k)
            jobs, is_rrna = got.mates, got.is_rrna
        elif len(dbs) == 1:
            jobs = (generate.make_job(dbs[0], traffic, seed, k),)
            is_rrna = jobs[0].is_rrna
        else:
            raise ValueError("single-end traffic reads one database; give "
                             "the traffic a 'paired' entry")
        files = []
        for m, job in enumerate(jobs, 1):
            path = os.path.join(tmp, f"job{k}.fq.gz" if len(jobs) == 1
                                else f"job{k}_{m}.fq.gz")
            generate.write_job(path, generate.fastq_bytes(job, seed, k, m))
            files.append(path)
        pool.append((files, is_rrna, sum(len(j.seqs) for j in jobs),
                     sum(len(s) for j in jobs for s in j.seqs)))
    return pool


def run_job(smr_main, db_paths, reads, wd, idx, flags) -> None:
    """One job: every database as a ``-ref`` and every reads file (a
    pair's two) as a ``-reads``, in order."""
    refs = [a for p in db_paths for a in ("-ref", p)]
    smr_main(refs + [a for p in reads for a in ("-reads", p)] + list(flags)
             + ["-idx-dir", idx, "-workdir", wd])


# ---------------------------------------------------------------------------
# tracing


class Tracer:
    """Per-layer observations of a ``--trace 1`` run: the ``run_all``
    phases by host clock (and as profiler spans), the SW kernel's bound
    counted at each fetch, and the profiler over the window."""

    PHASES = ("prepare", "run_align", "run_postprocess", "run_reports")

    def __init__(self, device):
        import torch
        from sortmerna_tpu_torch.engine import run as run_mod
        from sortmerna_tpu_torch.ops.sw_torch import TorchSwBackend
        self.torch = torch
        self.device = device
        self.run_mod = run_mod
        self.backend_cls = TorchSwBackend
        self.phase_s: Dict[str, float] = {}
        self.bound_s = 0.0
        self.launches = 0
        self.saved = {}
        self.prof = None
        self.lock = threading.Lock()      # fetches come from many threads
        self.last: Dict[str, float] = {}

    def _clocked(self, name, fn):
        torch, phase_s = self.torch, self.phase_s

        def inner(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench." + name):
                try:
                    return fn(*a, **kw)
                finally:
                    phase_s[name] = phase_s.get(name, 0.0) \
                        + time.perf_counter() - t0
        return inner

    def _fetch(self, fn):
        def inner(handle):
            res = fn(handle)
            for _, r in handle[0]:
                if r[0] is None:          # cpu: no kernel, no bound
                    continue
                host, stage = r[1].numpy(), r[2].numpy()
                ints = stage[:, -12:].copy().view("<i4")
                b = roofline.bound_s(roofline.fused_cells(ints, host),
                                     stage.nbytes + host.nbytes)
                with self.lock:
                    self.bound_s += b
                    self.launches += 1
            return res
        return staticmethod(inner)

    def install(self):
        for n in self.PHASES:
            self.saved[n] = getattr(self.run_mod, n)
            setattr(self.run_mod, n, self._clocked(n, self.saved[n]))
        self.saved["fetch"] = self.backend_cls.batch_coords_fetch
        self.backend_cls.batch_coords_fetch = self._fetch(
            self.saved["fetch"])

    def uninstall(self):
        for n in self.PHASES:
            setattr(self.run_mod, n, self.saved[n])
        self.backend_cls.batch_coords_fetch = staticmethod(
            self.saved["fetch"])

    def take_job_phases(self) -> Dict[str, float]:
        """The phases' seconds since the last call (one job's)."""
        got = {k: v - self.last.get(k, 0.0) for k, v in self.phase_s.items()}
        self.last = dict(self.phase_s)
        return got

    def job_span(self):
        return self.torch.profiler.record_function("bench.job")

    def start(self):
        if self.device == "cuda":
            P = self.torch.profiler
            self.prof = P.profile(activities=[P.ProfilerActivity.CPU,
                                              P.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.window = self.torch.profiler.record_function("bench.window")
        self.window.__enter__()

    def stop(self, tmp) -> dict:
        self.window.__exit__(None, None, None)
        if self.prof is None:
            return {}
        import devtrace
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        path = os.path.join(tmp, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        out = devtrace.reduce(*devtrace.load(path))
        os.remove(path)
        return out


# ---------------------------------------------------------------------------
# one run


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache_root: Optional[str] = None,
             fault: Optional[Callable] = None, warm_up: bool = True) -> dict:
    """Set up, run the window, judge it; returns the result object.
    ``fault`` (a ``faults.FAULTS`` entry) patches the port for the whole
    run, and ``warm_up`` False skips the warm-up job: the control's and
    the faults' readings.  The benchmark's own runs pass neither."""
    config, traffic = spec["config"], spec["traffic"]
    os.environ["SMR_TORCH_DEVICE"] = device
    os.environ["SMR_TIMERS"] = "1" if trace else "0"
    os.environ["SMR_TPU_LOG"] = "0"
    import torch
    from sortmerna_tpu_torch.cli import main as smr_main
    from sortmerna_tpu_torch import util
    if device == "cuda":
        torch.zeros(1, device="cuda")
    log(f"host cores {os.cpu_count()}; config {spec['cell']['config']}, "
        f"traffic {spec['cell']['traffic']}, seed {seed}")
    flags = config["flags"] + config["report_flags"]
    cache = os.path.join(cache_root or os.path.join(BENCH, ".cache"),
                         spec["cell"]["config"])
    tmp = tempfile.mkdtemp(prefix="smrbench_")
    tracer = None
    patched = contextlib.ExitStack()
    try:
        if fault is not None:
            patched.enter_context(fault())
        db_paths = ensure_databases(config, cache)
        idx = os.path.join(cache, "idx")
        dbs = [generate.read_fasta(p) for p in db_paths]
        pool = make_pool(dbs, generate.database_names(config["database"]),
                         traffic, seed, tmp)
        # the warm-up is a whole job (the pool's first): a smaller one
        # leaves the first timed job slower (the host's allocator and the
        # pinned staging buffers grow to a job's size then)
        t = time.perf_counter()
        if warm_up or not os.path.exists(os.path.join(cache, "ready")):
            run_job(smr_main, db_paths, pool[0][0],
                    os.path.join(tmp, "wd_warm"), idx, flags)
            shutil.rmtree(os.path.join(tmp, "wd_warm"))
        if not os.path.exists(os.path.join(cache, "ready")):
            open(os.path.join(cache, "ready"), "w").close()
            log(f"index and Gumbel cache built by the warm-up job in "
                f"{time.perf_counter() - t:.1f}s")
        else:
            log(f"warm-up job {time.perf_counter() - t:.3f}s of set-up")

        if trace:
            tracer = Tracer(device)
            tracer.install()
        rss_how = reset_rss_peak()
        log(f"peak RSS read as {rss_how}")
        util.TIMERS.clear()
        setup_s = time.perf_counter() - T0
        if tracer:
            tracer.start()
        probe0 = host_probe_ms()
        jobs, failed, t_start = [], 0, time.perf_counter()
        while True:
            k = len(jobs)
            files, is_rrna, n, nt = pool[k % len(pool)]
            wd = os.path.join(tmp, f"wd{k}")
            t = time.perf_counter()
            ru = resource.getrusage(resource.RUSAGE_SELF)
            try:
                with (tracer.job_span() if tracer
                      else contextlib.nullcontext()):
                    run_job(smr_main, db_paths, files, wd, idx, flags)
            except Exception:         # a job that fails ends the window
                traceback.print_exc()
                failed += 1
                break
            jobs.append(dict(fastq=files, out=os.path.join(wd, "out"),
                             is_rrna=is_rrna, reads=n, nt=nt,
                             wall=time.perf_counter() - t,
                             rusage=rusage_since(ru)))
            for sub in ("readb", "kvdb"):  # not judged: gone before flushed
                shutil.rmtree(os.path.join(wd, sub), ignore_errors=True)
            if tracer:
                jobs[-1]["phase_s"] = tracer.take_job_phases()
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        log(f"host probe: {probe0:.2f} ms before the window, "
            f"{host_probe_ms():.2f} ms after")
        if len(jobs) > len(pool):
            log(f"the window ran {len(jobs)} jobs on a pool of {len(pool)}: "
                "jobs after the pool's end repeat its files")
        dev = tracer.stop(tmp) if tracer else {}
        rss = rss_peak_bytes(rss_how)
        result_device = dict(
            platform="gpu" if device == "cuda" else "cpu",
            kind=torch.cuda.get_device_name() if device == "cuda"
            else "cpu", count=1 if device == "cuda" else 0,
            memory_peak_bytes=int(torch.cuda.max_memory_allocated())
            if device == "cuda" else 0)
        reads = sum(j["reads"] for j in jobs)
        obs = dict(jobs=jobs, window_s=window_s, reads=reads,
                   mnt=sum(j["nt"] for j in jobs) / 1e6,
                   phase_s=dict(tracer.phase_s) if tracer else {},
                   timers={k: list(v) for k, v in util.TIMERS.items()},
                   sw_bound_s=tracer.bound_s if tracer else 0.0,
                   sw_launches=tracer.launches if tracer else 0,
                   device=dev)
        if tracer:
            tracer.uninstall()
        log(f"window {window_s:.3f}s: {len(jobs)} jobs, {reads} reads, "
            f"job walls " + ", ".join(f"{j['wall']:.3f}" for j in jobs))
        for k, j in enumerate(jobs):
            log(f"job {k} host: " + ", ".join(
                f"{n} {v:.3f}" for n, v in j["rusage"].items()))
            if "phase_s" in j:
                log(f"job {k} phases: " + ", ".join(
                    f"{n} {v:.3f}s" for n, v in j["phase_s"].items()))

        metrics = {}
        if not trace:
            e2e = dict(reads_per_s=reads / window_s,
                       peak_rss_gib=rss / 2 ** 30, setup_s=setup_s)
            for m in spec["end_to_end"]:
                metrics[m["name"]] = dict(value=e2e[m["name"]],
                                          unit=m["unit"])
        elif jobs:
            for m in spec["per_layer"]:
                v = load_reader(m["name"])(obs)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
            if dev:
                result_device.update(busy_s=dev["busy_s"],
                                     window_s=dev["window_s"])

        # the judge, once the window has closed and the peak is read
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        gumbel_refs = []
        for path, db in zip(db_paths, dbs):
            t = time.perf_counter()
            gumbel_refs.append(gumbel.cached(
                gumbel_path(cache, path), judge.composition(db),
                config["scoring"], config["gumbel_fit"], device=device))
            log(f"the reference's Gumbel lambda {gumbel_refs[-1][0]:.6g}, "
                f"K {gumbel_refs[-1][1]:.6g}"
                + (f" of {os.path.basename(path)}" if len(dbs) > 1 else "")
                + f" ({time.perf_counter() - t:.1f}s)")
        t = time.perf_counter()
        nums = judge.judge(jobs, dbs, flags, config["scoring"],
                           config["evalue"], config["edges"],
                           traffic["judge_sample"], seed, gumbel_refs,
                           device=device)
        limits = traffic["limits"]
        compared = {k: dict(value=nums[k], limit=limits[k]) for k in limits}
        correct = failed == 0 and all(v["value"] <= v["limit"]
                                      for v in compared.values())
        log(f"judged every read and all {nums['rows']} BLAST rows of "
            f"{len(jobs)} jobs, {nums['rows_checked']} rows by plain SW, in "
            f"{time.perf_counter() - t:.1f}s")
        if "moved_max" in nums:
            log(f"at most {nums['moved_max']} reads a job counted on an "
                "earlier database than their row's")
        result = dict(correct=correct, attempted=len(jobs) + failed,
                      failed=failed,
                      metrics=metrics, device=result_device)
        if trace and dev:
            result["breakdown"] = dict(device_ops=dev["device_ops"],
                                       idle_gaps=dev["idle_gaps"])
        result["compared"] = compared
        return result
    finally:
        patched.close()
        if tracer and tracer.saved:
            tracer.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["cell"]["chips"]:
        log(f"needs {spec['cell']['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the port must not load: {bad}")
        return 3
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
