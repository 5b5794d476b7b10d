"""Exact ALP Gumbel provider (reference-identical lambda/K).

The reference computes gapped Gumbel parameters with the public-domain
NCBI ALP library (it vendors the tree at 3rdparty/alp), called with a
FIXED random seed and sample count so the result is deterministic for
given inputs (refstats.cpp:184-233: seed 182345345, 14112 samples, 39
preliminary).

The same public-domain tree is vendored in this package at
``sortmerna_tpu_torch/third_party/alp`` (see its README for provenance),
so the package is self-contained: this module builds a 30-line driver
against it, into ``build/alp_oracle_torch``, and invokes it to obtain
byte-identical lambda/K.  ``SMR_ALP_SRC`` can point at a different ALP
checkout; no other tree is read.  Results are
cached on disk, so the ~4 s simulation (docs/trace4.3.2.rst:161-165)
runs once per (scoring, composition).  Only when no compiler is present
does the caller fall back to the calibrated estimator in
stats/gumbel.py.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess
from typing import Optional, Tuple

_PKG = pathlib.Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG.parent / "build" / "alp_oracle_torch"
_BIN = _BUILD_DIR / "alp_oracle"

_DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include "sls_alignment_evaluer.hpp"
// Drives ALP exactly as refstats.cpp:184-233 does: fixed seed 182345345,
// 14112 samples, 39 preliminary-stage samples, eps 0.001/0.005, mem 500.
int main(int argc, char** argv) {
    if (argc < 9) {
        fprintf(stderr, "usage: oracle match mismatch go ge fA fC fG fT\n");
        return 2;
    }
    long match = atol(argv[1]), mismatch = atol(argv[2]);
    long go = atol(argv[3]), ge = atol(argv[4]);
    double f[4] = {atof(argv[5]), atof(argv[6]), atof(argv[7]),
                   atof(argv[8])};
    long n = 4;
    long** mat = new long*[n];
    for (long i = 0; i < n; ++i) {
        mat[i] = new long[n];
        for (long j = 0; j < n; ++j) mat[i][j] = (i == j) ? match : mismatch;
    }
    double f1[4], f2[4];
    for (int i = 0; i < 4; ++i) { f1[i] = f[i]; f2[i] = f[i]; }
    Sls::AlignmentEvaluer ev;
    try {
        ev.set_gapped_computation_parameters_simplified(-1, 14112, 39);
        ev.initGapped(n, (const long *const *)mat, f1, f2, go, ge, go, ge,
                      false, 0.001, 0.005, -1, 500, 182345345);
        printf("%.17g %.17g\n", ev.parameters().lambda, ev.parameters().K);
    } catch (Sls::error& e) {
        fprintf(stderr, "Sls error %ld: %s\n", e.error_code, e.st.c_str());
        return 1;
    }
    return 0;
}
"""


_VENDORED = _PKG / "third_party" / "alp"


def _alp_src() -> Optional[pathlib.Path]:
    p = os.environ.get("SMR_ALP_SRC")
    for path in ([pathlib.Path(p)] if p else []) + [_VENDORED]:
        if path.is_dir() and list(path.glob("*.cpp")):
            return path
    return None


@functools.lru_cache(maxsize=1)
def oracle_bin() -> Optional[pathlib.Path]:
    """Path to the built ALP driver, building it on first use; None if
    unavailable (no ALP source tree / no compiler)."""
    override = os.environ.get("SMR_ALP_ORACLE")
    if override and pathlib.Path(override).exists():
        return pathlib.Path(override)
    if _BIN.exists():
        return _BIN
    src = _alp_src()
    if src is None:
        return None
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        drv = _BUILD_DIR / ("oracle.%d.cpp" % os.getpid())
        drv.write_text(_DRIVER)
        srcs = sorted(str(p) for p in src.glob("*.cpp"))
        # temp name + atomic rename: concurrent first uses (test workers)
        # never see a half-written binary
        tmp = _BIN.with_suffix(".%d" % os.getpid())
        subprocess.run(
            ["g++", "-O2", f"-I{src}", "-o", str(tmp), str(drv)] + srcs,
            check=True, capture_output=True)
        os.replace(tmp, _BIN)
        drv.unlink(missing_ok=True)
        return _BIN
    except (OSError, subprocess.SubprocessError):
        return None


def available() -> bool:
    return oracle_bin() is not None


@functools.lru_cache(maxsize=None)
def _run(match: int, mismatch: int, go: int, ge: int,
         fa: str, fc: str, fg: str, ft: str
         ) -> Optional[Tuple[float, float]]:
    binp = oracle_bin()
    if binp is None:
        return None
    try:
        out = subprocess.run(
            [str(binp), str(match), str(mismatch), str(go), str(ge),
             fa, fc, fg, ft],
            check=True, capture_output=True, text=True, timeout=600)
        lam, k = out.stdout.split()
        return float(lam), float(k)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def alp_gumbel_exact(match: int, mismatch: int, go: int, ge: int,
                     freqs) -> Optional[Tuple[float, float]]:
    """Reference-identical (lambda, K), or None when ALP is unavailable."""
    f = [float(x) for x in freqs]
    return _run(int(match), int(mismatch), int(go), int(ge),
                "%.17g" % f[0], "%.17g" % f[1], "%.17g" % f[2],
                "%.17g" % f[3])
