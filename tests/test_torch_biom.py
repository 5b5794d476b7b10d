"""reports/biom.py: the port's BIOM skeleton against the JAX package's.

Both write the same JSON document apart from its ``date``, which each
takes from the clock (report_biom.cpp:49-62)."""

import json

import pytest

pytest.importorskip("torch")

from sortmerna_tpu.reports import biom as jbiom             # noqa: E402
from sortmerna_tpu_torch.reports import biom as tbiom       # noqa: E402


def test_biom_skeleton_matches_jax(tmp_path):
    docs = {}
    for name, mod in (("jax", jbiom), ("torch", tbiom)):
        path = tmp_path / f"{name}.biom"
        mod.biom_skeleton(str(path))
        docs[name] = json.loads(path.read_text())
    for doc in docs.values():
        assert len(doc.pop("date")) == len("2026-01-01T00:00:00")
    assert docs["torch"] == docs["jax"]
    assert docs["torch"]["generated_by"] == "sortmerna-tpu"
