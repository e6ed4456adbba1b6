"""Serving API (counterpart of ``sddm_tpu/enhance.py``).

``Enhancer`` cuts arbitrary-length waveforms into rows of the model's
training length, pads the rows to a fixed ``batch_rows`` per call, runs the
reverse sampler and trims each output back to its input's length.
``load_enhancer`` builds one from a JAX checkpoint and its config, serving
UNetModified2 through the packed engine (``PackedUNetModified2``) by
default, as the JAX package does, and the networks of the zoo (UNetSP,
UNetTST, CAUNet, TSTNN, UNetModified, DenoiseWaveGrad1/2/3, Waveunet,
Waveunet2, Waveunet3) plain, in eval mode.  Both run on the card unless the
caller asks for the CPU.

Where JAX shards each batch over a mesh of the devices one process drives,
the port runs one process per card under ``torchrun`` (``parallel/mesh.py``):
when the data mesh's ranks divide ``batch_rows``, each rank samples its rows
of every batch under its rows of the whole batch's noise, drawn on every
rank from the shared generator, and every rank gathers the whole batch.  So
the outputs do not depend on the number of ranks, as JAX's do not depend on
its mesh.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from math import ceil
from typing import List, Optional, Sequence

import numpy as np
import torch

from .cli import build_arch, build_diffusion, build_network
from .compat.jax_import import network_state_dict_from_jax
from .models.unet_modified2 import UNetModified2
from .models.unet_packed import PackedUNetModified2
from .parallel.mesh import all_finite, gather_rows, make_mesh, replicate, shard_batch
from .train.checkpoints import load_checkpoint
from .utils.profiling import span


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
                 generator: torch.Generator | None = None, mesh=None, warmup: bool = False,
                 warmup_timeout_s: Optional[float] = None):
        """``model``: an ``SDDM`` whose network lies on the serving device;
        ``num_samples``: the row length the model was trained on;
        ``batch_rows``: rows per sampler call (the last call is zero-padded);
        ``generator``: the sampler's noise source, seeded 0 on the model's
        device when not given (under a mesh it must be seeded alike on every
        rank); ``mesh``: the data mesh of ``parallel.make_mesh``, by default
        over the ``torchrun`` world, this process alone without one.
        ``warmup=True`` runs :meth:`warmup` (with ``warmup_timeout_s``) once
        here, so that the first request does not pay for the kernels' build
        and cuDNN's choices."""
        self.model = model
        self.num_samples = num_samples
        self.batch_rows = batch_rows
        self.device = next(model.network.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        if self.mesh.n_model > 1:
            raise ValueError("Enhancer serves over a data mesh; it has no model axis")
        if self.mesh.distributed and self.mesh.device != self.device:
            raise ValueError(f"the model lies on {self.device}, this rank serves on "
                             f"{self.mesh.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.engine_fallback = None  # why the loader serves a fallback engine, if it does
        if warmup:
            self.warmup(timeout_s=warmup_timeout_s)

    @property
    def sharded(self) -> bool:
        """Whether a batch is split over the data ranks: JAX's test, the
        mesh's size dividing ``batch_rows`` (``sddm_tpu/enhance.py:162``);
        otherwise every rank serves the whole batch."""
        return self.mesh.n_data > 1 and self.batch_rows % self.mesh.n_data == 0

    def _sample(self, cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """One sampler call on a batch of ``batch_rows`` rows, its outputs on
        every rank: split over the data ranks when :attr:`sharded`, each
        rank's rows under its rows of the whole batch's draws."""
        if not self.sharded:
            return self.model.infer(cond, generator)

        def mine(t):
            return shard_batch(t, self.mesh)

        stream = self.model.draw_noise_stream(cond.shape, generator, cond.device, cond.dtype,
                                              cut=mine)
        return gather_rows(self.model.infer(mine(cond), noise_stream=stream), self.mesh)

    def _canary(self) -> bool:
        """This rank's canary verdict (see :meth:`validate`)."""
        cond = 0.05 * np.random.default_rng(0).standard_normal(
            (self.batch_rows, 1, self.num_samples)).astype(np.float32)
        generator = torch.Generator(device=self.device).manual_seed(17)
        out = self.model.infer(torch.from_numpy(cond).to(self.device), generator)
        return bool(torch.isfinite(out).all())

    def validate(self) -> bool:
        """Canary: run the sampler once on a small random condition at the
        serving shape and check that every output element is finite.  The
        JAX package's check (``sddm_tpu/enhance.py::Enhancer.validate``):
        weight-dependent numerical failures can slip past random-init tests,
        so ``load_enhancer`` runs it once with the checkpoint's weights on the
        packed engine and serves the plain engine if it fails.  Each rank runs
        the whole canary, as JAX's runs unsharded, and the verdict is reduced
        over the ranks (:func:`parallel.all_finite`): every rank serves the
        same engine."""
        return all_finite(self._canary(), self.mesh)

    def warmup(self, timeout_s: Optional[float] = None) -> float:
        """Run the sampler once on zeros at the serving shape, split over the
        ranks as a served batch is, from a generator of its own (the served
        draws stay as they were); it covers the kernels' first build with
        nvcc, cuDNN's choice of algorithms, the allocator and the packed
        engine's capture of its forward in a CUDA graph.  Returns the
        wall seconds, ending in a device synchronise.  With ``timeout_s`` the
        call runs in a thread and this raises ``TimeoutError`` with a
        diagnostic when it has not finished in that time, as JAX's
        ``Enhancer.warmup`` does."""
        cond = torch.zeros((self.batch_rows, 1, self.num_samples), device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(0)
        on_card = self.device.type == "cuda"

        def call():
            # a thread starts on card 0: launch on this rank's card
            with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
                self._sample(cond, generator)
                if on_card:
                    torch.cuda.synchronize()

        start = time.perf_counter()
        if timeout_s is None:
            call()
            return time.perf_counter() - start
        done = threading.Event()
        err: list = []

        def run():
            try:
                call()
            except Exception as e:  # raised in the caller below
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True).start()
        if not done.wait(timeout_s):
            raise TimeoutError(
                f"Enhancer.warmup: the sampler call at shape ({self.batch_rows}, 1, "
                f"{self.num_samples}) on {self.device} did not finish in {timeout_s:.1f} s. "
                f"Its first call builds the GroupNorm+SiLU kernels with nvcc (seconds each) "
                f"and lets cuDNN choose its algorithms"
                + (f"; under a mesh of {self.mesh.n_data} data ranks it also waits for "
                   f"every rank's rows" if self.sharded else "")
                + ". Check that nvcc and the card answer, or retry with a longer timeout.")
        if err:
            raise err[0]
        return time.perf_counter() - start

    def _chunk(self, audio: np.ndarray) -> np.ndarray:
        """[T] -> [n_chunk, 1, num_samples], zero-padded."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        n_chunk = ceil(audio.shape[0] / self.num_samples)
        padded = np.zeros((n_chunk * self.num_samples,), np.float32)
        padded[: audio.shape[0]] = audio
        return padded.reshape(n_chunk, 1, self.num_samples)

    def enhance_batch(self, audios: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Enhance a list of arbitrary-length mono waveforms (under a mesh,
        every rank gives every rank's requests and gets every output).

        Spans (``utils/profiling``, while recording): ``enhance.call`` with
        ``rows``, ``padding_rows``, ``samples_in``, ``samples_sampled``;
        inside it ``enhance.chunk`` (rows in, answers out), and for each
        block ``enhance.to_device``, the sampler's ``sampler.call``,
        ``enhance.wait`` (on a card: the wait for an event recorded once the
        sampler returns, which the block's outputs precede) and
        ``enhance.to_host``."""
        with span("enhance.call") as call:
            with span("enhance.chunk"):
                chunks = [self._chunk(a) for a in audios]
                rows = np.concatenate(chunks, axis=0)
                owners = np.concatenate([np.full(c.shape[0], i) for i, c in enumerate(chunks)])

            outputs = np.zeros_like(rows)
            for start in range(0, rows.shape[0], self.batch_rows):
                with span("enhance.to_device"):
                    block = rows[start : start + self.batch_rows]
                    n_real = block.shape[0]
                    if n_real < self.batch_rows:
                        pad = np.zeros((self.batch_rows - n_real,) + block.shape[1:], block.dtype)
                        block = np.concatenate([block, pad], axis=0)
                    cond = torch.from_numpy(block).to(self.device)
                out = self._sample(cond, self.generator)
                with span("enhance.wait") as waited:
                    if waited is not None and self.device.type == "cuda":
                        # the copy back would wait here anyway: no result changes
                        ready = torch.cuda.Event()
                        ready.record(torch.cuda.current_stream(self.device))
                        ready.synchronize()
                with span("enhance.to_host"):
                    outputs[start : start + n_real] = out[:n_real].float().cpu().numpy()

            with span("enhance.chunk"):
                answers = [outputs[owners == i].reshape(-1)[: np.asarray(a).size]
                           for i, a in enumerate(audios)]
            if call is not None:
                sampled = -(-rows.shape[0] // self.batch_rows) * self.batch_rows
                call.attrs.update(rows=int(rows.shape[0]),
                                  padding_rows=int(sampled - rows.shape[0]),
                                  samples_in=int(sum(a.size for a in answers)),
                                  samples_sampled=int(sampled * self.num_samples))
            return answers

    def enhance(self, audio: np.ndarray) -> np.ndarray:
        return self.enhance_batch([audio])[0]


def load_network_weights(network, checkpoint_path):
    """Load a JAX checkpoint's weights into ``network`` through the weight
    bridge, whose structure (levels, layers) comes from the built module, so
    that a config may leave any of it to the module's default, as in the JAX
    package.  Returns ``network``."""
    params = load_checkpoint(checkpoint_path)["params"]
    network.load_state_dict(network_state_dict_from_jax(network, params))
    return network


def load_enhancer(checkpoint_path, config: dict, batch_rows: int = 16,
                  steps: int = 0, ddim: bool = False, device=None,
                  packed: bool = True, mesh=None, warmup: bool = False,
                  warmup_timeout_s: Optional[float] = None,
                  validate_packed: bool = True) -> Enhancer:
    """An ``Enhancer`` for a JAX ``SDDM`` checkpoint of a waveform denoiser
    (``UNetModified2`` or a network of ``cli.ZOO``) and its config dict.
    ``steps=n`` samples over an n-step subsequence of the trained schedule,
    ``ddim=True`` with the DDIM update; the defaults run the full trained-T
    ancestral sampler.  ``device`` defaults to ``cuda``; a given ``mesh``
    brings its own.

    ``mesh`` (default: ``parallel.make_mesh`` over the ``torchrun`` world,
    which starts its process group; this process alone without one): every
    rank builds its replica on its own card (``cuda:LOCAL_RANK``; the CPU
    under ``device="cpu"``), takes rank 0's weights and serves each batch
    split over the ranks when they divide ``batch_rows``
    (:class:`Enhancer`).  ``warmup`` and ``warmup_timeout_s`` are
    :meth:`Enhancer.warmup`'s, run when each enhancer is built, as in the
    JAX package.

    ``packed=True`` (the default) serves a UNetModified2 through the
    space-to-depth engine ``PackedUNetModified2``, the same function with
    NHWC activations, when the network has no dropout; it is ignored for the
    other networks, as in the JAX package.  With ``validate_packed=True``
    (the default) the engine is checked once with the checkpoint's weights
    (:meth:`Enhancer.validate`, its verdict the same on every rank); on a
    non-finite output the loader logs a warning and serves the plain
    network, as the JAX package's ``load_enhancer`` does, and records why on
    the returned enhancer (``engine_fallback = "canary"``; None when nothing
    fell back).  ``validate_packed=False`` serves the engine unchecked."""
    if mesh is None:
        mesh = make_mesh(device=device)
    network = build_network(config, num_samples=config["num_samples"])
    load_network_weights(network, checkpoint_path).to(mesh.device).eval()
    replicate(network, mesh)
    diffusion = build_diffusion(config)

    def enhancer_of(net):
        model = build_arch(config, diffusion, net)
        if ddim:
            model = model.with_ddim()
        if steps:
            model = model.with_sampling_steps(int(steps))
        return Enhancer(model, config["num_samples"], batch_rows, mesh=mesh, warmup=warmup,
                        warmup_timeout_s=warmup_timeout_s)

    fallback = None
    if packed and isinstance(network, UNetModified2) and not network.dropout:
        enhancer = enhancer_of(PackedUNetModified2(network).eval())
        if not validate_packed or enhancer.validate():
            return enhancer
        logging.getLogger("enhance").warning(
            "packed-engine canary produced non-finite output with the checkpoint "
            "weights; serving the plain engine instead")
        fallback = "canary"
    enhancer = enhancer_of(network)
    enhancer.engine_fallback = fallback
    return enhancer
