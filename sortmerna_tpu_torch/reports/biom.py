"""BIOM report stub (report_biom.cpp:46-62 -- the reference only writes a
skeleton JSON header and is not wired into writeReports; kept for surface
parity)."""

from __future__ import annotations

import json
import time


def biom_skeleton(path: str) -> None:
    """Write the skeleton BIOM header (report_biom.cpp:49-62)."""
    doc = {
        "id": None,
        "format": "1.0.0",
        "format_url": "http://biom-format.org",
        "type": "OTU table",
        "generated_by": "sortmerna-tpu",
        "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "rows": [],
        "columns": [],
        "matrix_type": "sparse",
        "matrix_element_type": "int",
        "shape": [0, 0],
        "data": [],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
