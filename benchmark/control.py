"""The readings a cell's limits are set from, on the chip at the cell's own
size, in one process:

    python3 -m benchmark.control --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--faults half_batch] [--seconds 3]

For every seed: set-up, a short window at the cell's own load, and the
numbers its outputs are held to (the lower readings: the program against
the reference).  For each control seed besides, the same numbers with the
reference computed in fp8 in the program's place (the upper readings).
With ``--faults``, every seed's program runs with those faults planted
under its timed path.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys


def reading(cell, seed: int, seconds: float, device, control: bool, faults=()) -> dict:
    from benchmark.cells import KINDS
    from benchmark.reference import plain

    driver = KINDS[cell.traffic["kind"]](cell, seed, device, None, faults)
    driver.setup()
    driver.window(seconds)
    e2e = driver.end_to_end()
    driver.release()
    readings = getattr(driver, "readings", driver.checks)
    out = {"seed": seed, "faults": list(faults), "failed": driver.failed, "e2e": e2e,
           "checks": readings()}
    if control:
        out["control"] = driver.control(plain.Precision(fp8=True))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell_of(harness.load_spec(), args.workload)
    for seed in args.seeds:
        r = reading(cell, seed, args.seconds, torch.device("cuda", 0),
                    seed in args.control_seeds, tuple(args.faults))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
