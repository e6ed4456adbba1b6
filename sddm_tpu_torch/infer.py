"""Chunked full-utterance enhancement and scoring (counterpart of the root
``infer.py``, same flags).

Each noisy utterance of the config's ``infer_dataset`` is cut into rows of
``num_samples`` samples; each of the loader's batches of rows runs through
the reverse sampler at its own row count (the JAX CLI pads every batch to
the dataset-wide largest for one compiled program, which eager PyTorch does
not need); the rows are regrouped by file and written as
``samples/{output,target,condition}/<name>.wav`` in a new run dir
(log-modulus companding undone for ``.logwav.npy`` data); then
``evaluate`` scores the samples dir.  The network is the config's
UNetModified2 with the checkpoint's weights, served through the packed
engine ``PackedUNetModified2`` when the config says ``"packed": true``, as
the JAX package's ``infer.py`` serves its packed engine.  It runs on the
card unless ``-d cpu`` is given.

Usage: python -m sddm_tpu_torch.infer -r <run>/model_best.ckpt [-c config.json] [-d cpu]
           [--steps N] [--ddim [ETA]] [--continuous]
"""

from __future__ import annotations

import numpy as np
import torch

from .cli import (
    build_arch,
    build_data_loader,
    build_dataset,
    build_diffusion,
    build_loss,
    build_network,
    standard_argparser,
)
from .data.loaders import InferDataLoader
from .data.wav_io import save_wav
from .enhance import load_unet_weights, resolve_device
from .evaluate import evaluate
from .models.unet_packed import PackedUNetModified2
from .ops.logaudio import log_modulus_normalize_reverse
from .utils import ConfigParser

EXPAND_ORDER = 3


def build_model(config, device, num_steps=None, ddim_eta=None):
    """The served ``SDDM``: the config's UNetModified2 with the weights of the
    checkpoint ``config.resume`` on ``device`` (the packed engine under
    ``"packed": true``), with ``with_ddim(ddim_eta)`` applied before
    ``with_sampling_steps(num_steps)``, as the JAX CLI composes them."""
    if config.resume is None:
        raise SystemExit("infer requires -r/--resume pointing at a checkpoint")
    if config["network"]["type"] != "UNetModified2":
        raise NotImplementedError(f"infer serves UNetModified2, got {config['network']['type']!r}")
    network = build_network(config, num_samples=config["num_samples"])
    load_unet_weights(network, config.resume).to(device).eval()
    if config.get("packed"):  # build_network refused "packed" with dropout
        network = PackedUNetModified2(network).eval()
    model = build_arch(config, build_diffusion(config), network)
    if ddim_eta is not None:
        model = model.with_ddim(ddim_eta)
    if num_steps is not None:
        model = model.with_sampling_steps(num_steps)
    return model


def main(config, continuous=False, num_steps=None, ddim_eta=None, seed=0) -> dict:
    """Enhance the config's ``infer_dataset`` into ``config.save_dir /
    "samples"`` and score it; returns ``evaluate``'s result.  The sampler
    draws from one ``torch.Generator`` on the device, seeded ``seed``."""
    logger = config.get_logger("infer")
    device = resolve_device(config.device)
    datatype = config["infer_dataset"]["args"]["datatype"]
    sample_rate = config["sample_rate"]

    infer_dataset = build_dataset(config, "infer_dataset", sample_rate=sample_rate,
                                  T=config["num_samples"])
    if "infer_data_loader" in config:
        infer_data_loader = build_data_loader(config, "infer_data_loader", infer_dataset)
    else:  # a config without the block serves at data_loader's batch size
        infer_data_loader = InferDataLoader(
            infer_dataset, batch_size=config["data_loader"]["args"].get("batch_size", 4))
    logger.info("Finished initializing datasets")

    model = build_model(config, device, num_steps, ddim_eta)
    if ddim_eta is not None:
        logger.info("DDIM sampler (eta=%g)", ddim_eta)
    if num_steps is not None:
        logger.info("fast sampling: %d reverse steps", model.num_timesteps)
    logger.info("Loaded checkpoint: %s (%s on %s)", config.resume,
                type(model.network).__name__, device)
    loss_fn = build_loss(config)
    generator = torch.Generator(device=device).manual_seed(seed)

    sample_path = config.save_dir / "samples"
    paths = {name: sample_path / name for name in ("target", "output", "condition")}
    for p in paths.values():
        p.mkdir(parents=True, exist_ok=True)
    if continuous:
        interm_path = sample_path / "intermediate"
        interm_path.mkdir(parents=True, exist_ok=True)

    def save_group(name, arrays):
        for kind, data in arrays.items():
            wav = np.asarray(data).reshape(1, -1)
            if datatype == ".logwav.npy":
                wav = log_modulus_normalize_reverse(torch.from_numpy(wav), EXPAND_ORDER).numpy()
            save_wav(paths[kind] / f"{name}.wav", wav, sample_rate)

    total_loss, n_batches = 0.0, 0
    for target, condition, index in infer_data_loader:
        cond = torch.from_numpy(condition).to(device)
        if continuous:
            output, traj = model.infer(cond, generator, return_trajectory=True)
            stride = model.sample_interval()
            traj_np = traj.float().cpu().numpy()  # [T, B, 1, chunk]
            steps = traj_np.shape[0]
            for file_idx in np.unique(index):
                rows = np.nonzero(index == file_idx)[0]
                name = infer_dataset.get_name(int(file_idx))
                for t_rev in range(0, steps, stride):
                    save_wav(interm_path / f"{name}_t{steps - t_rev:04d}.wav",
                             traj_np[t_rev][rows].reshape(1, -1), sample_rate)
        else:
            output = model.infer(cond, generator)
        output_np = output.float().cpu().numpy()

        # regroup chunk rows by file index and flush every file
        for file_idx in np.unique(index):
            rows = np.nonzero(index == file_idx)[0]
            save_group(infer_dataset.get_name(int(file_idx)),
                       {"output": output_np[rows], "target": target[rows],
                        "condition": condition[rows]})

        total_loss += float(loss_fn(torch.from_numpy(output_np), torch.from_numpy(target)))
        n_batches += 1

    logger.info({"loss": total_loss / max(n_batches, 1)})
    return evaluate(sample_path, ".wav", sample_rate, {"pesq_wb", "sisnr", "stoi"}, logger)


def parse_args(argv=None):
    """``(ConfigParser, argparse namespace)`` from the command line ``argv``."""
    args = standard_argparser("Speech denoising diffusion model inference")
    args.add_argument("--continuous", action="store_true",
                      help="also save intermediate samples every 1|(T//100) steps")
    args.add_argument("--steps", type=int, default=None,
                      help="fast sampling: run this many reverse steps (<= T) over a "
                      "subsequence of the trained schedule")
    args.add_argument("--ddim", type=float, default=None, nargs="?", const=0.0, metavar="ETA",
                      help="serve with the DDIM sampler (deterministic at the default "
                      "eta=0); combine with --steps for few-step enhancement")
    parsed = args.parse_args(argv)
    return ConfigParser.from_args(parsed), parsed


def run(argv=None) -> dict:
    """What ``python -m sddm_tpu_torch.infer`` does with ``argv``."""
    config, parsed = parse_args(argv)
    return main(config, continuous=parsed.continuous, num_steps=parsed.steps,
                ddim_eta=parsed.ddim)


if __name__ == "__main__":
    run()
