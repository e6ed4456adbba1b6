"""A four-card entry for the harness's tests of several ranks: the r256
client over a data mesh, with the r256 cell's limits.  ``BENCHMARK.json``
holds no four-card cell (PERF.md, section 7); the tests add this entry to a
copy of the spec."""

from __future__ import annotations

import copy

from benchmark import harness

BASE = "enhance-flagship-r256"
NAME = "enhance-flagship-mesh4-r256"
ENTRY = {"name": NAME, "config": "unet-modified2-flagship", "traffic": "enhance-r256",
         "chips": 4, "why": "the r256 client over a 4-rank data mesh"}


def spec_with_mesh(spec=None) -> dict:
    spec = copy.deepcopy(spec if spec is not None else harness.load_spec())
    spec["workloads"].append(dict(ENTRY))
    for m in spec["end_to_end"]:
        if m["name"] in ("serve_audio_s_per_s", "serve_p95_ms"):
            m["workloads"].append(NAME)
    return spec


def cell():
    spec = spec_with_mesh()
    mesh = harness.cell_of(spec, NAME)
    mesh.limits = harness.cell_of(spec, BASE).limits
    return mesh
