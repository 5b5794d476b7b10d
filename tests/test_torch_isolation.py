"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* a static scan of every module of sortmerna_tpu_torch/ and of
  chip_smoke.py finds no import of ``jax`` or of ``sortmerna_tpu``;
* a full CLI run of the port on the CPU, in a fresh interpreter, leaves no
  ``jax*`` or ``sortmerna_tpu.*`` module in ``sys.modules``;
* without a GPU the default device (``cuda``) raises at every entry point
  instead of running on the CPU.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.engine import run as trun          # noqa: E402
from sortmerna_tpu_torch.ops.sw_torch import TorchSwBackend  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "sortmerna_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "sortmerna_tpu"


def _imports(path: pathlib.Path):
    """Every module name the file imports: import statements (relative
    ones resolved against the package) and importlib / __import__ calls
    with a constant name."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if fname in ("import_module", "__import__"):
                yield node.args[0].value


def test_static_scan_finds_no_jax_and_no_jax_package():
    assert len(PORT_FILES) > 40
    bad = [(str(p.relative_to(REPO)), m) for p in PORT_FILES
           for m in _imports(p) if _forbidden(m)]
    assert not bad
    # the scan does see the port's own imports (relative ones resolved)
    names = set(_imports(REPO / "sortmerna_tpu_torch" / "engine" / "run.py"))
    assert "sortmerna_tpu_torch.ops.sw_torch" in names
    assert not _forbidden("sortmerna_tpu_torch.ops")
    assert _forbidden("sortmerna_tpu.ops") and _forbidden("jaxlib")


_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from sortmerna_tpu_torch.cli import main
rc = main(sys.argv[2:])
print("MODULES " + json.dumps(sorted(
    m for m in sys.modules
    if m.split(".")[0].startswith("jax") or m.split(".")[0] == "sortmerna_tpu")))
print("RC", rc)
"""


def test_cli_run_imports_no_jax_and_no_jax_package(tmp_path):
    db = str(tmp_path / "db.fasta")
    reads = str(tmp_path / "reads.fasta")
    seqs = testing.make_db(db, 30, n_families=3, len_range=(1300, 1400),
                           seed=51)
    testing.make_reads(reads, seqs, 300, seed=52)
    env = dict(os.environ, SMR_TORCH_DEVICE="cpu")
    p = subprocess.run(
        [sys.executable, "-c", _CHILD, str(REPO), "-ref", db, "-reads", reads]
        + testing.VERIFY_FLAGS
        + ["-idx-dir", str(tmp_path / "idx"), "-workdir", str(tmp_path / "wd")],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("MODULES ")]
    assert json.loads(line[-1][len("MODULES "):]) == []
    assert "RC 0" in p.stdout
    out = testing.read_outputs(str(tmp_path / "wd" / "out"))
    assert out["aligned.fa"].count(b">") > 0


@pytest.fixture
def no_gpu(monkeypatch):
    """The entry points as they behave on a machine without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(no_gpu, tmp_path, monkeypatch):
    mat = np.eye(5, dtype=np.int32)
    with pytest.raises(RuntimeError, match="is_available"):
        TorchSwBackend(mat, 5, 2)
    with pytest.raises(RuntimeError, match="is_available"):
        TorchSwBackend(mat, 5, 2, device="cuda")
    assert TorchSwBackend(mat, 5, 2, device="cpu").device.type == "cpu"

    db = str(tmp_path / "db.fasta")
    reads = str(tmp_path / "reads.fasta")
    testing.make_reads(reads, testing.make_db(db, 4, n_families=2, seed=5),
                       10, seed=6)
    wd = tmp_path / "wd"
    opts = tcli.parse_args(["-ref", db, "-reads", reads,
                            "-workdir", str(wd)])
    with pytest.raises(RuntimeError, match="is_available"):
        trun.run_all(opts)
    # it failed before any host work: no index, no reports
    assert not (wd / "out" / "aligned.log").exists()
    monkeypatch.delenv("SMR_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["-ref", db, "-reads", reads, "-workdir", str(wd)])
