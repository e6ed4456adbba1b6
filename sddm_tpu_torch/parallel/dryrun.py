"""Train steps and served batches over several processes, launched as ``torchrun``
launches them (counterpart of ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` starts ``n`` gloo CPU processes that run the
shipped ``make_train_step`` once on the tiny flagship (72 samples, inner 8,
4 groups, mults 1-2, 16/8 framing, T = 5, AMSGrad 1e-3) with int16 batches,
so the step's dequantisation runs too: first over the data mesh (DDP), then
tensor-parallel over a ``(n / m, m)`` mesh, ``m`` = 4 where it divides ``n``
(and then over ``(n / 2, 2)`` as well), else 2.  The legs draw the q process of the global batch from one seeded
generator and hand each rank its rows, so they compute the same loss, which
must agree within 1e-4 (as JAX's dry run asserts).

:func:`step_parity` runs ``steps`` train steps of a UNetModified2 SDDM from
given weights, batch and draws over a mesh of ``n`` ranks and writes the
loss of each step, the whole gradients of the first and the whole
parameters after the last to an ``.npz`` (rank 0), and each rank's kernel
launches, rows and sharded parameters to ``rank<r>.json``.  A network with
``dropout > 0`` draws its masks as the trainer does, from a generator seeded
``rank_seed(0, data rank)``; each rank writes the first step's masks to
``rank<r>_masks.npz``.  Parity runs: TF32 off.

:func:`serve_parity` serves given requests through ``load_enhancer`` over a
data mesh of ``n`` ranks, case by case (a checkpoint, a config's overrides,
``batch_rows``, steps, the engine, the generator's seed, a rank whose canary
is made to fail, a warmup limit), and writes each rank's gathered outputs
to ``<case>/rank<r>.npz`` and its engine, rows, kernel launches (the
wrappers' calls), the packed engine's graph captures and replays, and
seconds to ``<case>/rank<r>.json``.  Parity runs: TF32 off.

Usage: python -m sddm_tpu_torch.parallel.dryrun [N]
       python -m sddm_tpu_torch.parallel.dryrun [N] --step INPUTS.npz OUT_DIR
           [--model-parallel 1,2] [--device cpu|cuda]
       python -m sddm_tpu_torch.parallel.dryrun [N] --serve INPUTS.npz OUT_DIR
           [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TINY = dict(num_samples=72, inner_channel=8, norm_groups=4, channel_mults=(1, 2), res_blocks=1,
            segment_len=16, segment_stride=8)
TINY_STEPS = 5
AMSGRAD = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
LOSS_AGREEMENT = 1e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, n: int, timeout: float = 600.0, env: dict | None = None) -> list:
    """Run ``python -m sddm_tpu_torch.parallel.dryrun *args`` as ``n`` ranks
    with ``torchrun``'s variables (one host, a free localhost port); returns
    each rank's standard output, or raises with the failures' errors."""
    port = free_port()
    root = Path(__file__).resolve().parents[2]
    procs = []
    for rank in range(n):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                        OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-m", "sddm_tpu_torch.parallel.dryrun",
                                       *map(str, args)], cwd=str(root), env=rank_env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs, errors = [], []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                errors.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def tiny_flagship(n_timestep: int = TINY_STEPS):
    """The tiny flagship SDDM (``condition_in``, a linear schedule from 1e-6
    to 1e-3) over a UNetModified2 of :data:`TINY`'s widths."""
    from ..diffusion.schedule import DiffusionSchedule
    from ..models import UNetModified2
    from ..models.sddm import SDDM

    schedule = DiffusionSchedule.create("linear", n_timestep, 1e-6, 1e-3)
    return SDDM(schedule, UNetModified2(**TINY), p_transition="condition_in")


def int16_batch(rows: int, num_samples: int):
    """The dry run's int16 (target, condition), as JAX's dry run draws them."""
    rng = np.random.default_rng(0)
    target = (rng.normal(size=(rows, 1, num_samples)) * 0.1 * 32768).clip(-32768, 32767)
    target = target.astype(np.int16)
    condition = (target.astype(np.float32)
                 + rng.normal(size=(rows, 1, num_samples)) * 0.02 * 32768)
    return target, condition.clip(-32768, 32767).astype(np.int16)


def global_draws(rows: int, shape: tuple, num_timesteps: int, seed: int = 0):
    """``q_stochastic``'s (t, frac, eps) for a global batch of ``rows``."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(1, num_timesteps + 1, (rows,), generator=gen),
            torch.rand((rows,), generator=gen), torch.randn(shape, generator=gen))


def _one_step(mesh, weights, target, condition, draws) -> float:
    """One step of the tiny flagship from ``weights`` over ``mesh``; the
    global mean loss."""
    from ..models.losses import l1_loss
    from ..train.state import make_optimizer
    from ..train.trainer import make_train_step
    from . import global_mean, parallel_model, shard_batch

    model = tiny_flagship()
    model.network.load_state_dict(weights)
    optimizer = make_optimizer(AMSGRAD, model.network.parameters())
    step = make_train_step(parallel_model(model, optimizer, mesh), l1_loss, optimizer)
    local = shard_batch((torch.from_numpy(target), torch.from_numpy(condition)), mesh)
    loss = step(*local, draws=shard_batch(draws, mesh))
    return float(global_mean(loss, mesh))


def _dryrun_worker() -> None:
    from ..train.trainer import init_parameters
    from .mesh import init_world, world_rank, world_size
    from .tensor import make_mesh_2d
    from . import make_mesh

    init_world("cpu")
    n = world_size()
    rows = 2 * n
    target, condition = int16_batch(rows, TINY["num_samples"])
    draws = global_draws(rows, target.shape, TINY_STEPS)
    net = tiny_flagship().network
    init_parameters(net, torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in net.state_dict().items()}

    loss = _one_step(make_mesh(device="cpu"), weights, target, condition, draws)
    if not math.isfinite(loss):
        raise AssertionError("non-finite loss in the multi-process dry run")
    record = {"ranks": n, "loss": loss, "tensor_parallel": {}}
    mp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    # JAX's second leg, and where the model axis is 4, a (n / 2, 2) mesh too, whose
    # replicated leaves average over a data axis of more than one rank
    for m in ([mp, 2] if mp == 4 else [mp] if mp > 1 else []):
        loss_tp = _one_step(make_mesh_2d(n // m, m, device="cpu"), weights, target, condition,
                            draws)
        if not math.isfinite(loss_tp):
            raise AssertionError("non-finite loss under tensor parallelism")
        if abs(loss_tp - loss) >= LOSS_AGREEMENT:
            raise AssertionError(f"tensor-parallel loss {loss_tp} over (data {n // m}, model "
                                 f"{m}) != data-parallel loss {loss}")
        record["tensor_parallel"][m] = loss_tp
    record["model_parallel"] = mp
    if world_rank() == 0:
        print(json.dumps(record), flush=True)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """One train step of the tiny flagship over ``n_devices`` gloo CPU ranks,
    data-parallel and then tensor-parallel; returns rank 0's record (``loss``,
    ``model_parallel``, ``tensor_parallel``: the loss of each model-axis size)
    or raises."""
    outs = launch([], n_devices, timeout)
    return json.loads(outs[0].strip().splitlines()[-1])


def _step_worker(inputs: Path, out_dir: Path, model_parallel: int, device: str) -> None:
    """One rank of :func:`step_parity` over the mesh of ``model_parallel``."""
    from ..cli import build_arch, build_diffusion, build_optimizer
    from ..models import UNetModified2
    from ..models.losses import l1_loss
    from ..ops.gn_silu import gn_silu, gn_silu_backward
    from ..train.trainer import make_train_step
    from ..models.dropout import DropoutMasks
    from . import global_mean, make_mesh, parallel_model, rank_seed, shard_batch
    from .mesh import world_rank, world_size
    from .tensor import _dtensor, full, make_mesh_2d

    data = np.load(inputs)
    config = json.loads(str(data["config"]))
    n = world_size()
    mesh = (make_mesh(device=device) if model_parallel <= 1
            else make_mesh_2d(n // model_parallel, model_parallel, device=device))
    dev = mesh.device
    network = UNetModified2(num_samples=config["num_samples"], **config["network"]["args"])
    network.load_state_dict({k[2:]: torch.from_numpy(data[k]) for k in data.files
                             if k.startswith("w/")})
    network.to(dev)
    network.dtype = getattr(torch, config.get("dtype", "float32"))
    names = [name for name, _ in network.named_parameters()]
    optimizer = build_optimizer(config, network)
    model = build_arch(config, build_diffusion(config), network)
    step = make_train_step(parallel_model(model, optimizer, mesh), l1_loss, optimizer)
    batch = shard_batch(tuple(torch.from_numpy(data[k]).to(dev) for k in ("target", "condition")),
                        mesh)
    generator = torch.Generator(device=dev).manual_seed(rank_seed(0, mesh.data_rank))
    gn_silu.launches = gn_silu_backward.launches = 0
    losses, grads, masks = [], {}, []
    for k in range(int(data["steps"])):
        draws = shard_batch(tuple(torch.from_numpy(data[f"{name}_{k}"]).to(dev)
                                  for name in ("t", "frac", "eps")), mesh)
        dropout = DropoutMasks(generator)
        losses.append(float(global_mean(step(*batch, draws=draws, dropout=dropout), mesh)))
        if k == 0:
            grads = {name: full(p, p.grad).float().cpu().numpy()
                     for name, p in network.named_parameters()}
            masks = [m.cpu().numpy() for m in dropout.drawn]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = [gn_silu.launches, gn_silu_backward.launches]
    params = {name: full(p).float().cpu().numpy() for name, p in network.named_parameters()}
    sharded = [name for name, p in network.named_parameters() if isinstance(p, _dtensor())]
    rank = world_rank()
    out_dir.mkdir(parents=True, exist_ok=True)
    if masks:
        np.savez(out_dir / f"rank{rank}_masks.npz", *masks)
    (out_dir / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "ranks": n, "rows": int(batch[0].shape[0]), "losses": losses,
        "launches": launches, "sharded": sharded, "parameters": names, "device": str(dev),
        "backend": torch.distributed.get_backend()}))
    if rank == 0:
        np.savez(out_dir / "result.npz", losses=np.asarray(losses),
                 **{f"grad/{k}": v for k, v in grads.items()},
                 **{f"param/{k}": v for k, v in params.items()})


def step_parity(inputs: Path, out_dir: Path, ranks: int, model_parallel=(1,),
                device: str = "cpu", backend: str | None = None, timeout: float = 600.0) -> dict:
    """Run :func:`_step_worker` on ``ranks`` ranks, over the mesh of each of
    ``model_parallel`` in turn (1: the data mesh), in the same processes;
    returns ``{m: {"arrays": rank 0's arrays, "ranks": every rank's record}}``.
    ``inputs`` (``.npz``) holds ``config`` (JSON: ``num_samples``,
    ``network``, ``diffusion``, ``arch``, ``optimizer`` and optionally
    ``dtype``), the weights ``w/<name>``, the global ``target`` and
    ``condition``, ``steps`` and each step's global draws ``t_k``, ``frac_k``
    and ``eps_k``.  ``backend="gloo"`` with ``device="cuda"`` runs every rank
    on the one card over gloo."""
    mps = ",".join(str(int(m)) for m in model_parallel)
    args = ["--step", inputs, out_dir, "--model-parallel", mps, "--device", device]
    env = {"SDDM_DRYRUN_BACKEND": backend} if backend else None
    launch(args, ranks, timeout, env)
    out = {}
    for m in model_parallel:
        sub = out_dir / f"mp{m}"
        records = [json.loads((sub / f"rank{r}.json").read_text()) for r in range(ranks)]
        with np.load(sub / "result.npz") as result:
            out[int(m)] = {"arrays": {k: result[k] for k in result.files}, "ranks": records}
    return out


def _serve_worker(inputs: Path, out_dir: Path, device: str) -> None:
    """One rank of :func:`serve_parity`."""
    from unittest import mock

    from ..enhance import Enhancer, load_enhancer
    from ..ops.gn_silu import gn_silu, gn_silu_nhwc
    from . import make_mesh
    from .mesh import world_rank, world_size

    data = np.load(inputs)
    config = json.loads(str(data["config"]))
    audios = [data[f"request_{i}"] for i in range(int(data["requests"]))]
    mesh = make_mesh(device=device)
    dev, rank = mesh.device, world_rank()

    def synchronize():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for case in json.loads(str(data["cases"])):
        timeout = case.get("warmup_timeout_s")
        failing = case.get("fail_canary_rank") == rank
        with mock.patch.object(Enhancer, "_canary", lambda self: False) if failing \
                else contextlib.nullcontext():
            enh = load_enhancer(case["checkpoint"], {**config, **case.get("config", {})},
                                batch_rows=case["batch_rows"], steps=case.get("steps", 0),
                                ddim=case.get("ddim", False), packed=case.get("packed", True),
                                mesh=mesh, warmup=timeout is not None, warmup_timeout_s=timeout,
                                validate_packed=case.get("validate_packed", True))
        warmup_s = enh.warmup() if timeout is not None else None
        enh.generator = torch.Generator(device=dev).manual_seed(case["seed"])
        synchronize()
        gn_silu.launches = gn_silu_nhwc.launches = 0
        net = enh.model.network
        graphs = [getattr(net, "captures", 0), getattr(net, "replays", 0)]
        start = time.perf_counter()
        outputs = enh.enhance_batch(audios)
        synchronize()
        seconds = time.perf_counter() - start
        graphs = [getattr(net, "captures", 0) - graphs[0], getattr(net, "replays", 0) - graphs[1]]
        sub = out_dir / case["name"]
        sub.mkdir(parents=True, exist_ok=True)
        np.savez(sub / f"rank{rank}.npz", *outputs)
        (sub / f"rank{rank}.json").write_text(json.dumps({
            "rank": rank, "ranks": world_size(), "device": str(dev),
            "backend": torch.distributed.get_backend(), "engine": type(enh.model.network).__name__,
            "engine_fallback": enh.engine_fallback, "sharded": enh.sharded,
            "rows": enh.batch_rows // mesh.n_data if enh.sharded else enh.batch_rows,
            "launches": {"gn_silu_nhwc": gn_silu_nhwc.launches, "gn_silu": gn_silu.launches},
            "graph_captures": graphs[0], "graph_replays": graphs[1],
            "seconds": seconds, "warmup_s": warmup_s,
            "cuda_initialized": torch.cuda.is_initialized()}))


def serve_inputs(path: Path, config: dict, audios, cases) -> Path:
    """Write :func:`serve_parity`'s inputs: ``config`` (a dict), the requests
    ``audios`` (1-D arrays) and ``cases``, dicts with ``name``,
    ``checkpoint`` (a path), ``batch_rows`` and ``seed``, and optionally
    ``config`` (top-level keys over the config's), ``steps``, ``ddim``,
    ``packed``, ``validate_packed``, ``fail_canary_rank`` and
    ``warmup_timeout_s`` (``warmup=True`` with that limit, then one more
    ``warmup()`` timed)."""
    np.savez(path, config=json.dumps(config), cases=json.dumps(cases, default=str),
             requests=len(audios), **{f"request_{i}": np.asarray(a, np.float32)
                                      for i, a in enumerate(audios)})
    return path


def serve_records(inputs: Path, out_dir: Path, ranks: int) -> dict:
    """What ``ranks`` ranks of :func:`_serve_worker` wrote under ``out_dir``:
    ``{case: {"ranks": every rank's record, "outputs": every rank's list of
    served waveforms}}``."""
    with np.load(inputs) as data:
        names = [case["name"] for case in json.loads(str(data["cases"]))]
    out = {}
    for name in names:
        sub = out_dir / name
        out[name] = {"ranks": [], "outputs": []}
        for r in range(ranks):
            out[name]["ranks"].append(json.loads((sub / f"rank{r}.json").read_text()))
            with np.load(sub / f"rank{r}.npz") as served:
                out[name]["outputs"].append([served[f"arr_{i}"] for i in range(len(served.files))])
    return out


def serve_parity(inputs: Path, out_dir: Path, ranks: int, device: str = "cpu",
                 backend: str | None = None, timeout: float = 600.0) -> dict:
    """Run :func:`_serve_worker` on ``ranks`` ranks over the inputs of
    :func:`serve_inputs`; returns :func:`serve_records`.  ``backend="gloo"``
    with ``device="cuda"`` runs every rank on the one card over gloo."""
    env = {"SDDM_DRYRUN_BACKEND": backend} if backend else None
    launch(["--serve", inputs, out_dir, "--device", device], ranks, timeout, env)
    return serve_records(inputs, out_dir, ranks)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ranks", nargs="?", type=int,
                        help="launch the dry run over this many gloo CPU ranks")
    parser.add_argument("--step", nargs=2, metavar=("INPUTS", "OUT_DIR"))
    parser.add_argument("--serve", nargs=2, metavar=("INPUTS", "OUT_DIR"))
    parser.add_argument("--model-parallel", default="1",
                        help="comma-separated model-axis sizes, one mesh each (1: data mesh)")
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    mps = [int(m) for m in args.model_parallel.split(",")]
    if "RANK" in os.environ:  # a rank launched by launch()
        from .mesh import finish_world, init_world

        torch.set_num_threads(1)
        if args.step or args.serve:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            init_world(args.device, backend=os.environ.get("SDDM_DRYRUN_BACKEND"))
        if args.serve:
            _serve_worker(Path(args.serve[0]), Path(args.serve[1]), args.device)
        elif args.step:
            for m in mps:
                _step_worker(Path(args.step[0]), Path(args.step[1]) / f"mp{m}", m, args.device)
        else:
            _dryrun_worker()
        finish_world()
        return
    if args.serve:
        record = serve_parity(Path(args.serve[0]), Path(args.serve[1]), args.ranks or 2,
                              args.device)
        print(json.dumps({name: r["ranks"] for name, r in record.items()}))
        return
    if args.step:
        record = step_parity(Path(args.step[0]), Path(args.step[1]), args.ranks or 2, mps,
                             args.device)
        print(json.dumps({m: r["ranks"][0]["losses"] for m, r in record.items()}))
        return
    print(json.dumps(dryrun_multichip(args.ranks or 2)))


if __name__ == "__main__":
    main()
