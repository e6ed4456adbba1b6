"""Run one cell of ``BENCHMARK.json`` once and print its result:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for; without them it prints no result and exits 2.  A cell on
several cards runs ``torchrun`` over ``benchmark.worker``, one rank a card.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up counts from the process's start

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def parse(argv=None, extra=False):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    if extra:
        p.add_argument("--t0", type=float, required=True)
    return p.parse_args(argv)


def launch_ranks(args, chips: int) -> int:
    """``torchrun`` with a rank a card on this host; its standard output is
    passed on once every rank has ended, so rank 0's result stays last."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(chips), "-m", "benchmark.worker",
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", repr(args.seconds), "--trace", str(args.trace), "--t0", repr(T0)]
    env = dict(os.environ, OMP_NUM_THREADS="2", USE_FLAX="0", USE_JAX="0")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env, text=True)
    try:
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sys.stdout.write(out)
    sys.stdout.flush()
    return proc.returncode


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.cell_of(harness.load_spec(), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        return launch_ranks(args, cell.chips)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t0=T0)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
