"""The diffusion trainer (counterpart of ``sddm_tpu/train/trainer.py``):
epsilon-prediction train steps and periodic validation with the sampler.

Per batch of ``(target, condition, index)``: int16 PCM batches dequantised
(/32768), float batches (``WaveGradDataLoader``'s audio and spectrogram
crops) as they are, the q process sampled and its noise predicted
(``SDDM.forward``; ``SDDM_spectrogram`` featurizes a raw-audio condition
first; the network's dropout masks drawn after the q draws, from the same
generator), the criterion, ``backward`` and one optimizer step
(:func:`make_train_step`).  The epoch's loss is the mean of
every step's loss, read from the device once at the epoch's end; ``log_step``
only feeds the writer.  Every ``valid_period`` epochs the sampler (the full
T steps, or ``valid_steps`` / ``valid_ddim``) runs on ``n_valid_data_batch``
batches: loss and metrics against the clean target, and the output and
target WAVs in ``<run>/samples/``.  ``profile_dir`` traces steps [2, 12) of
the first epoch with ``torch.profiler`` into ``trace.json``, the program's
spans of those steps among its events.

Over a mesh of ranks (``parallel/``) the step runs under DDP on a data mesh,
or on parameters sharded over the model axis of a ``(data, model)`` mesh;
each data rank draws its q process and its dropout masks from a generator
seeded ``(seed, data rank)``, so that the model ranks of one data shard draw
the same masks, the losses and metrics logged are the means over the data axis,
and rank 0 alone writes the samples, checkpoints (full, gathered trees) and
traces.
Without a process group the mesh is this process alone and the trainer runs
as it always has.
"""

from __future__ import annotations

import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data.wav_io import save_wav
from ..models.initializers import init_network
from ..models.unet_packed import plain_network
from ..parallel import global_mean, make_mesh, parallel_model, rank_seed
from ..utils import profiling
from ..utils.profiling import span
from ..utils.util import MetricTracker, inf_loop, param_count
from .base_trainer import BaseTrainer


def _dequant(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM batches (the RAM-cached loader's) -> float32 / 32768, as
    ``load_wav`` scales them; float batches pass as they are."""
    if x.dtype == torch.int16:
        return x.float() / 32768.0
    return x


def make_train_step(model, criterion, optimizer):
    """The train step as a function of ``(target, condition, generator=None,
    draws=None, dropout=None) -> loss``: dequant, ``model.forward`` (the q
    draws from ``generator``, or ``draws`` as ``q_stochastic`` takes them;
    the dropout masks from ``dropout``, a ``DropoutMasks``, by default drawn
    from ``generator`` after the q draws), the criterion on (predicted,
    drawn) noise, ``backward`` and ``optimizer.step()``.  The loss is
    returned on the device, detached.

    Spans (``utils/profiling``, while recording): ``train.step``, inside it
    ``train.forward`` (dequant, forward, criterion), ``train.backward`` and
    ``train.optimizer`` (the step; the gradients are set to None before the
    forward, which launches nothing), each timed on the card too
    (``Span.device_ms``) when the batch lies there."""

    def train_step(target, condition, generator=None, draws=None, dropout=None):
        on_card = target.is_cuda
        with span("train.step"):
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward", device=on_card):
                target, condition = _dequant(target), _dequant(condition)
                predicted, noise = model.forward(target, condition, generator, draws, dropout)
                loss = criterion(predicted, noise)
            with span("train.backward", device=on_card):
                loss.backward()
            with span("train.optimizer", device=on_card):
                optimizer.step()
            return loss.detach()

    return train_step


@torch.no_grad()
def init_parameters(network: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw the network's initial parameters from ``generator`` (a CPU
    generator, so that a seed gives the same weights on any device), each
    from the JAX package's initialiser of that leaf.  A network with
    ``init_weights`` (DiffWave, WaveGrad) draws its own; the others
    through ``initializers.init_network``: torch's default initialisation
    of ``Conv2d`` and ``Linear``, U(-1/sqrt(fan in), 1/sqrt(fan in)) for
    weight and bias, as the JAX package's ``torch_conv``/``torch_dense``
    initialise, flax's defaults for the layers that are a flax ``nn.Conv``
    or ``nn.Dense`` there (the SNR path's), norms at weight 1, bias 0.
    The packed training twin draws its plain network's weights."""
    network = plain_network(network)
    init_weights = getattr(network, "init_weights", None)
    if init_weights is not None:
        init_weights(generator)
        return
    init_network(network, generator)


class Trainer(BaseTrainer):
    """Trains ``model.network`` on ``device`` (its parameters' device) over
    ``mesh`` (default: the data mesh of the world, this process alone
    without a process group).  The initial weights come from a CPU generator
    seeded ``seed``, the q process, the dropout masks and the validation
    sampler draw from a generator on ``device`` seeded ``rank_seed(seed, data
    rank)`` (``seed`` on rank 0); validation runs in eval mode;
    ``config.resume`` replaces the weights, the optimizer state, the
    epoch and the monitor's best with a checkpoint's, before the network is
    spread over the mesh (``parallel_model``)."""

    def __init__(self, model, criterion, metric_ftns, optimizer, config, data_loader,
                 valid_data_loader=None, len_epoch=None, seed=0, mesh=None):
        super().__init__(model, criterion, metric_ftns, optimizer, config)
        self.data_loader = data_loader
        if len_epoch is None:
            self.len_epoch = len(data_loader)
        else:
            self.data_loader = inf_loop(data_loader)
            self.len_epoch = len_epoch
        self.valid_data_loader = valid_data_loader
        self.do_validation = valid_data_loader is not None
        cfg_trainer = config["trainer"]
        self.n_valid_data_batch = cfg_trainer.get("n_valid_data_batch", 2)
        self.log_step = cfg_trainer.get("log_step", 100)
        # few-step validation: "valid_steps": n samples over an n-step
        # subsequence of the schedule, "valid_ddim": true with the DDIM update
        self.valid_model = self.model
        if cfg_trainer.get("valid_ddim", False):
            self.valid_model = self.valid_model.with_ddim()
        if cfg_trainer.get("valid_steps"):
            self.valid_model = self.valid_model.with_sampling_steps(int(cfg_trainer["valid_steps"]))

        self.train_metrics = MetricTracker("loss", writer=self.writer)
        self.valid_metrics = MetricTracker("loss", *[m.__name__ for m in self.metric_ftns],
                                           writer=self.writer)
        sample_path = config.save_dir / "samples"
        self.target_path = sample_path / "target"
        self.output_path = sample_path / "output"
        self.condition_path = sample_path / "condition"
        for p in (self.target_path, self.output_path, self.condition_path):
            p.mkdir(parents=True, exist_ok=True)

        network = self.model.network
        self.device = next(network.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        init_parameters(network, torch.Generator().manual_seed(seed))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, self.mesh.data_rank))
        self.logger.info("Trainable parameters: %d", param_count(network))
        self._maybe_resume()
        self._train_step = make_train_step(parallel_model(self.model, self.optimizer, self.mesh),
                                           self.criterion, self.optimizer)

    def _train_epoch(self, epoch: int) -> dict:
        self.epoch_start = time.time()
        self.train_metrics.reset()
        self.model.network.train()
        profile_dir = self.config["trainer"].get("profile_dir")
        profile_armed = bool(profile_dir) and epoch == self.start_epoch and self.mesh.is_main
        prof = None

        step_losses = []  # device scalars; one host sync at the epoch's end
        batches = iter(self.data_loader)
        for batch_idx in itertools.count():
            with span("train.data"):  # the wait for the loader and the copy to the card
                batch = next(batches, None)
                if batch is not None:
                    target, condition = self._to_device(*batch[:2])
            if batch is None:
                break
            if profile_armed and batch_idx == 2:
                since, prof = profiling.mark(), _start_profile()
            if prof is not None and batch_idx == 12:
                _stop_profile(prof, profile_dir, since)
                prof, profile_armed = None, False
            loss = self._train_step(target, condition, self.generator)
            step_losses.append(loss)
            if batch_idx > 0 and batch_idx % self.log_step == 0:
                loss_val = float(global_mean(loss, self.mesh))
                self.writer.set_step((epoch - 1) * self.len_epoch + batch_idx)
                self.train_metrics.update("loss", loss_val)
                self.logger.debug("Train Epoch: %s %s Loss: %.6f", epoch,
                                  self._progress(batch_idx), loss_val)
            if batch_idx == self.len_epoch:
                break
        if prof is not None:
            _stop_profile(prof, profile_dir, since)
        log = self.train_metrics.result()
        if step_losses:
            losses = global_mean(torch.stack(step_losses), self.mesh)
            log["loss"] = float(np.mean(losses.cpu().numpy(), dtype=np.float64))
        if self.do_validation and epoch % self.valid_period == 0:
            val_log = self._valid_epoch(epoch)
            log.update(**{"val_" + k: v for k, v in val_log.items()})
        return log

    def _valid_epoch(self, epoch: int) -> dict:
        self.logger.debug("Valid Epoch: %s started at +%.0fs", epoch,
                          time.time() - self.epoch_start)
        self.model.network.eval()
        self.valid_metrics.reset()
        sample_rate = self.config.get("sample_rate", 16000)
        for batch_idx, (target, condition, _idx) in enumerate(self.valid_data_loader):
            if batch_idx >= self.n_valid_data_batch:
                break
            target_d, condition_d = (_dequant(a) for a in self._to_device(target, condition))
            with torch.no_grad():
                output = self.valid_model.infer(condition_d, self.generator)
                loss = self.criterion(output, target_d)
                mets = {m.__name__: m(output, target_d) for m in self.metric_ftns}
            self.writer.set_step((epoch - 1) * len(self.valid_data_loader) + batch_idx, "valid")
            values = self._global_floats([loss, *mets.values()])
            self.valid_metrics.update("loss", values[0])
            for name, value in zip(mets, values[1:]):
                self.valid_metrics.update(name, value)
            if not self.mesh.is_main:
                continue
            out_np = output.float().cpu().numpy()
            tgt_np = target_d.float().cpu().numpy()
            for i in range(tgt_np.shape[0]):
                save_wav(self.output_path / f"{batch_idx}_{i}.wav", out_np[i].reshape(-1),
                         sample_rate)
                save_wav(self.target_path / f"{batch_idx}_{i}.wav", tgt_np[i].reshape(-1),
                         sample_rate)
        self.model.network.train()
        self.logger.debug("Valid Epoch: %s finished at +%.0fs", epoch,
                          time.time() - self.epoch_start)
        return self.valid_metrics.result()


def _start_profile():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir, since: int) -> None:
    """Stop the trace and write it as ``<profile_dir>/trace.json`` (Chrome
    trace format), with the program's spans opened after the mark ``since``
    (``train.data``, ``train.step`` and its phases) among its events."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    trace = Path(profile_dir) / "trace.json"
    prof.export_chrome_trace(str(trace))
    doc = json.loads(trace.read_text())
    doc["traceEvents"] += profiling.chrome_events(profiling.spans(since),
                                                  doc.get("baseTimeNanoseconds", 0))
    trace.write_text(json.dumps(doc))
