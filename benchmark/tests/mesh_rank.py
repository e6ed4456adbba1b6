"""One rank of the mesh cell's run at a size a test holds, on the CPU over
gloo (``torchrun --nproc_per_node 2 benchmark/tests/mesh_rank.py [fault]``):
rank 0 prints whether the run came out correct."""

import copy
import json
import sys
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch.distributed as dist  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.tests import mesh_cell  # noqa: E402
from sddm_tpu_torch.parallel.mesh import finish_world, init_world, make_mesh  # noqa: E402


def main():
    cell = mesh_cell.cell()
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["dtype"] = "float32"
    cfg["network"]["args"].update(inner_channel=8, norm_groups=4)
    tr.update(batch_rows=4, fill_rows=4)
    tr["sampler"]["steps"] = 2
    tr["lengths"].update(median_s=1.5, min_s=0.5, max_s=3.0, grid=16)
    tr["check"]["calls"] = 2
    cell.config, cell.traffic = cfg, tr
    init_world("cpu")
    mesh = make_mesh(device="cpu")
    ctl = dist.new_group(backend="gloo", timeout=timedelta(minutes=5))
    try:
        r = harness.run(cell, 2**31 + 5, 0.5, False, "cpu", mesh=mesh, ctl=ctl,
                        faults=tuple(sys.argv[1:]))
        if mesh.is_main:
            print(json.dumps({"correct": r["correct"], "checks": r["checks"],
                              "attempted": r["attempted"]}))
    finally:
        finish_world()


if __name__ == "__main__":
    main()
