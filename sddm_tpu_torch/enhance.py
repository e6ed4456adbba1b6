"""Serving API (counterpart of ``sddm_tpu/enhance.py``).

``Enhancer`` cuts arbitrary-length waveforms into rows of the model's
training length, pads the rows to a fixed ``batch_rows`` per call, runs the
reverse sampler and trims each output back to its input's length.
``load_enhancer`` builds one from a JAX checkpoint and its config, serving
UNetModified2 through the packed engine (``PackedUNetModified2``) by
default, as the JAX package does.  Both run on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import logging
from math import ceil
from typing import List, Sequence

import numpy as np
import torch

from .cli import build_arch, build_diffusion, build_network
from .compat.jax_import import state_dict_from_jax
from .models.unet_packed import PackedUNetModified2
from .train.checkpoints import load_checkpoint


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or ``cuda`` when none is given; without a card
    and without an explicit device this raises instead of using the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(on the command line: -d cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Enhancer:
    def __init__(self, model, num_samples: int, batch_rows: int = 16,
                 generator: torch.Generator | None = None):
        """``model``: an ``SDDM`` whose network lies on the serving device;
        ``num_samples``: the row length the model was trained on;
        ``batch_rows``: rows per sampler call (the last call is zero-padded);
        ``generator``: the sampler's noise source, seeded 0 on the model's
        device when not given."""
        self.model = model
        self.num_samples = num_samples
        self.batch_rows = batch_rows
        self.device = next(model.network.parameters()).device
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.engine_fallback = None  # why the loader serves a fallback engine, if it does

    def validate(self) -> bool:
        """Canary: run the sampler once on a small random condition at the
        serving shape and check that every output element is finite.  The
        JAX package's check (``sddm_tpu/enhance.py::Enhancer.validate``):
        weight-dependent numerical failures can slip past random-init tests,
        so ``load_enhancer`` runs it once with the checkpoint's weights on the
        packed engine and serves the plain engine if it fails."""
        cond = 0.05 * np.random.default_rng(0).standard_normal(
            (self.batch_rows, 1, self.num_samples)).astype(np.float32)
        generator = torch.Generator(device=self.device).manual_seed(17)
        out = self.model.infer(torch.from_numpy(cond).to(self.device), generator)
        return bool(torch.isfinite(out).all())

    def _chunk(self, audio: np.ndarray) -> np.ndarray:
        """[T] -> [n_chunk, 1, num_samples], zero-padded."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        n_chunk = ceil(audio.shape[0] / self.num_samples)
        padded = np.zeros((n_chunk * self.num_samples,), np.float32)
        padded[: audio.shape[0]] = audio
        return padded.reshape(n_chunk, 1, self.num_samples)

    def enhance_batch(self, audios: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Enhance a list of arbitrary-length mono waveforms."""
        chunks = [self._chunk(a) for a in audios]
        rows = np.concatenate(chunks, axis=0)
        owners = np.concatenate([np.full(c.shape[0], i) for i, c in enumerate(chunks)])

        outputs = np.zeros_like(rows)
        for start in range(0, rows.shape[0], self.batch_rows):
            block = rows[start : start + self.batch_rows]
            n_real = block.shape[0]
            if n_real < self.batch_rows:
                pad = np.zeros((self.batch_rows - n_real,) + block.shape[1:], block.dtype)
                block = np.concatenate([block, pad], axis=0)
            cond = torch.from_numpy(block).to(self.device)
            out = self.model.infer(cond, self.generator)
            outputs[start : start + n_real] = out[:n_real].float().cpu().numpy()

        return [outputs[owners == i].reshape(-1)[: np.asarray(a).size]
                for i, a in enumerate(audios)]

    def enhance(self, audio: np.ndarray) -> np.ndarray:
        return self.enhance_batch([audio])[0]


def load_unet_weights(network, checkpoint_path):
    """Load a JAX ``UNetModified2`` checkpoint's weights into ``network``,
    whose level structure (``channel_mults``, ``res_blocks``,
    ``inner_channel``) comes from the built module, so that a config may
    leave any of them to the module's default, as in the JAX package.
    Returns ``network``."""
    params = load_checkpoint(checkpoint_path)["params"]
    network.load_state_dict(state_dict_from_jax(
        params, channel_mults=network.channel_mults, res_blocks=network.res_blocks,
        inner_channel=network.inner_channel))
    return network


def load_enhancer(checkpoint_path, config: dict, batch_rows: int = 16,
                  steps: int = 0, ddim: bool = False, device=None,
                  packed: bool = True) -> Enhancer:
    """An ``Enhancer`` for a JAX ``SDDM`` + ``UNetModified2`` checkpoint and
    its config dict.  ``steps=n`` samples over an n-step subsequence of the
    trained schedule, ``ddim=True`` with the DDIM update; the defaults run
    the full trained-T ancestral sampler.  ``device`` defaults to ``cuda``.

    ``packed=True`` (the default) serves through the space-to-depth engine
    ``PackedUNetModified2``, the same function with NHWC activations, when
    the network has no dropout.  It is checked once with the checkpoint's
    weights (:meth:`Enhancer.validate`); on a non-finite output the loader
    logs a warning and serves the plain network, as the JAX package's
    ``load_enhancer`` does, and records why on the returned enhancer
    (``engine_fallback = "canary"``; None when nothing fell back)."""
    device = resolve_device(device)
    network = build_network(config, num_samples=config["num_samples"])
    load_unet_weights(network, checkpoint_path).to(device).eval()
    diffusion = build_diffusion(config)

    def fewstep(model):
        if ddim:
            model = model.with_ddim()
        return model.with_sampling_steps(int(steps)) if steps else model

    fallback = None
    if packed and not network.dropout:
        engine = PackedUNetModified2(network).eval()
        enhancer = Enhancer(fewstep(build_arch(config, diffusion, engine)),
                            config["num_samples"], batch_rows)
        if enhancer.validate():
            return enhancer
        logging.getLogger("enhance").warning(
            "packed-engine canary produced non-finite output with the checkpoint "
            "weights; serving the plain engine instead")
        fallback = "canary"
    enhancer = Enhancer(fewstep(build_arch(config, diffusion, network)), config["num_samples"],
                        batch_rows)
    enhancer.engine_fallback = fallback
    return enhancer
