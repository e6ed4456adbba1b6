"""One rank of a cell on several cards, started by ``benchmark.run`` under
``torchrun``: every rank serves the same client from the same seed (the
program splits each batch over the ranks), rank 0 prints the result."""

from __future__ import annotations

import sys
from datetime import timedelta


def main(argv=None) -> int:
    from benchmark.run import parse

    args = parse(argv, extra=True)
    import torch.distributed as dist

    from benchmark import harness
    from sddm_tpu_torch.parallel.mesh import finish_world, init_world, make_mesh

    cell = harness.cell_of(harness.load_spec(), args.workload)
    init_world()  # make_mesh counts the world's ranks: start it first
    mesh = make_mesh()
    ctl = dist.new_group(backend="gloo", timeout=timedelta(minutes=30))
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), mesh.device,
                             mesh=mesh, t0=args.t0, ctl=ctl)
        return harness.emit(result) if mesh.is_main else 0
    finally:
        finish_world()


if __name__ == "__main__":
    sys.exit(main())
