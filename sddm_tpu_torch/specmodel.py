"""Spectrogram-conditioned models: the assembly and checkpoint load of the
root ``test.py`` (counterpart of its lines 48-90), for a JAX
``SDDM_spectrogram`` + ``DiffWave`` checkpoint.

``load_specmodel`` returns the sampler on the card unless the caller asks
for the CPU; ``model.infer(condition, generator)`` then vocodes a batch of
spectrograms ``[B, freq, frames]`` or of raw audio ``[B, 1, T]``, which the
model's ``feature_fn`` turns into the spectrogram the checkpoint was
trained on.
"""

from __future__ import annotations

from .cli import build_arch, build_diffusion, build_network
from .compat.jax_import import diffwave_state_dict_from_jax
from .enhance import resolve_device
from .models.diffwave_fused import FusedDiffWave
from .models.sddm import SDDM_spectrogram
from .ops.spectrogram import make_feature_fn
from .train.checkpoints import load_checkpoint


def load_specmodel(checkpoint_path, config: dict, steps: int = 0, ddim: bool = False,
                   device=None) -> SDDM_spectrogram:
    """An ``SDDM_spectrogram`` for a JAX DiffWave checkpoint and its config
    dict, with its network on ``device`` (``cuda`` when not given).
    ``"packed": true`` in the config serves the fused engine.  ``steps=n``
    samples over an n-step subsequence of the trained schedule, ``ddim=True``
    with the DDIM update; the defaults run the full trained-T ancestral
    sampler."""
    device = resolve_device(device)
    network = build_network(config, device=device)
    net = network.net if isinstance(network, FusedDiffWave) else network
    params = load_checkpoint(checkpoint_path)["params"]
    net.load_state_dict(diffwave_state_dict_from_jax(
        params, residual_layers=len(net.residual_layers)))
    network.to(device).eval()

    spec_cfg = config.get("spectrogram", {})
    loader_args = config.get("test_data_loader", {}).get("args", {})
    hop = loader_args.get("hop_samples") or spec_cfg.get("hop_samples")
    kind = "mel" if "mel" in str(spec_cfg.get("kind", "spec")) else "spec"
    feature_fn = make_feature_fn(
        kind, spec_cfg["window_length"], hop,
        n_mels=config.get("mel_spectrogram", {}).get("n_mels"),
        sample_rate=config.get("sample_rate", 16000))
    model = build_arch(config, build_diffusion(config), network, hop_samples=hop,
                       feature_fn=feature_fn)
    if ddim:
        model = model.with_ddim()
    if steps:
        model = model.with_sampling_steps(int(steps))
    return model
