"""Everything a run makes from ``--seed``: the weights, the audio, and the
requests of a traffic mix.

A traffic mix is a JSON file of parameters (``benchmark/traffic/<mix>.json``);
the generators here read it.  Every seed gets the same sizes and the same
amount of work in another order: lengths are quantiles of the mix's length
distribution, shuffled by the seed, so that two seeds differ in content and
order, not in load.
"""

from __future__ import annotations

from math import ceil, prod

import numpy as np
import torch

STREAMS = {"weights": 1, "audio": 2, "order": 3, "noise": 4, "check": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each of a run's random streams."""
    ss = np.random.SeedSequence((int(seed) & (2**63 - 1), STREAMS[stream]))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


# ---- weights --------------------------------------------------------------------
@torch.no_grad()
def seeded_weights(module: torch.nn.Module, seed: int, device) -> dict:
    """Fill every parameter of ``module`` (on ``device``) from one draw on
    ``device``: tensors of two or more axes N(0, 1 / fan in), fan in the
    product of all axes but the first; the 1-D ``weight`` of a norm
    1 + N(0, 0.1^2); every other 1-D tensor (a bias) N(0, 0.05^2).  Returns
    ``{name: tensor}``, float32 copies the program never writes to."""
    params = dict(module.named_parameters())
    total = sum(p.numel() for p in params.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    views, scales, shifts, off = [], [], [], 0
    for name, p in params.items():
        view = flat[off: off + p.numel()].view(p.shape)
        off += p.numel()
        views.append(view)
        if p.dim() >= 2:
            scales.append(prod(p.shape[1:]) ** -0.5)
            shifts.append(0.0)
        elif name.endswith("weight"):
            scales.append(0.1)
            shifts.append(1.0)
        else:
            scales.append(0.05)
            shifts.append(0.0)
    torch._foreach_mul_(views, scales)
    torch._foreach_add_(views, shifts)
    torch._foreach_copy_(list(params.values()), views)
    return dict(zip(params, views))


# ---- audio -------------------------------------------------------------------------
def speech_like(rows: int, n: int, gen: torch.Generator, sample_rate: int = 16000,
                rms: float = 0.05) -> torch.Tensor:
    """``[rows, n]`` float32 on ``gen``'s device: white noise under a speech
    spectrum (a 1/f tilt with a formant-like lift at 300-3400 Hz), modulated
    at a syllable rate (a 4 Hz envelope of shaped noise), scaled to ``rms``."""
    dev = gen.device
    z = torch.randn(rows, n, generator=gen, device=dev)
    f = torch.fft.rfftfreq(n, 1.0 / sample_rate).to(dev)
    shape = 1.0 / torch.sqrt(1.0 + (f / 500.0) ** 2)
    shape = shape * (1.0 + 2.0 * ((f > 300) & (f < 3400)))
    x = torch.fft.irfft(torch.fft.rfft(z) * shape, n=n)
    env_z = torch.randn(rows, n, generator=gen, device=dev)
    env = torch.fft.irfft(torch.fft.rfft(env_z) * (f < 4.0), n=n).abs()
    x = x * (env / env.std(dim=1, keepdim=True).clamp_min(1e-12) + 0.1)
    return rms * x / x.std(dim=1, keepdim=True).clamp_min(1e-12)


def noisy_pair(rows: int, n: int, gen: torch.Generator, snrs_db) -> tuple:
    """``(clean, noisy)``, each ``[rows, n]``: speech-like clean signals and
    the same under white-ish background noise at ``snrs_db[i]`` for row i."""
    clean = speech_like(rows, n, gen)
    noise = speech_like(rows, n, gen, rms=1.0)
    snr = torch.as_tensor(np.asarray(snrs_db, np.float32), device=clean.device)[:, None]
    gain = clean.std(dim=1, keepdim=True) / 10.0 ** (snr / 20.0)
    return clean, clean + gain * noise


def snr_grid(rows: int, traffic: dict) -> np.ndarray:
    lo, hi = traffic.get("snr_db", (0.0, 15.0))
    return np.linspace(lo, hi, rows)


# ---- enhancement requests -------------------------------------------------------------
class EnhanceRequests:
    """The requests of an enhancement mix, call after call: each call takes
    the next utterances while their rows (``ceil(len / num_samples)``) fit in
    ``fill_rows``.  Lengths are the mix's log-normal quantiles at ``grid``
    points, clipped, shuffled by the seed each time the grid is used up;
    each utterance is a slice, at a seeded offset, of a pool of noisy
    speech-like audio made once."""

    def __init__(self, traffic: dict, seed: int, num_samples: int, sample_rate: int = 16000):
        lens = traffic["lengths"]
        n = int(lens["grid"])
        q = (np.arange(n) + 0.5) / n
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(v) for v in q])
        seconds = np.clip(lens["median_s"] * np.exp(lens["sigma"] * z), lens["min_s"],
                          lens["max_s"])
        self.lengths = np.round(seconds * sample_rate).astype(np.int64)
        self.num_samples = num_samples
        self.fill_rows = int(traffic["fill_rows"])
        self.rng = np.random.default_rng(stream_seed(seed, "order"))
        pool_s = float(traffic.get("pool_s", 60.0))
        rows = int(traffic.get("pool_rows", 16))
        per_row = int(pool_s * sample_rate / rows)
        gen = generator(seed, "audio")
        _, noisy = noisy_pair(rows, per_row, gen, snr_grid(rows, traffic))
        self.pool = noisy.reshape(-1).numpy()
        self.order: list = []
        self.next_id = 0

    def _next_length(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(self.lengths))
        return int(self.order[-1])

    def next_call(self) -> list:
        """``[(request id, audio)]`` of the next call."""
        call, rows = [], 0
        while True:
            length = self._next_length()
            need = ceil(length / self.num_samples)
            if rows + need > self.fill_rows:
                return call
            self.order.pop()
            off = int(self.rng.integers(0, self.pool.size - length))
            call.append((self.next_id, self.pool[off: off + length]))
            self.next_id += 1
            rows += need


# ---- spectrograms ------------------------------------------------------------------------
def stft_features(audio: np.ndarray, n_fft: int, hop: int, frames: int) -> np.ndarray:
    """The vocoder's condition, made with NumPy: |STFT| with a periodic
    Hamming window, centre reflect padding, normalised by sqrt(sum w^2),
    log-compressed to ``clip((log10 |S| - 1 + 5) / 5, 0, 1)``; ``[rows,
    n_fft / 2 + 1, frames]``."""
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    padded = np.pad(audio, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(padded[:, idx] * window, axis=-1)) / np.sqrt((window**2).sum())
    with np.errstate(divide="ignore"):
        feat = np.clip((np.log10(spec) - 1.0 + 5.0) / 5.0, 0.0, 1.0)
    return feat.transpose(0, 2, 1).astype(np.float32)


class VocodeRequests:
    """The calls of a vocoding mix: ``batch`` spectrograms of ``frames``
    frames each, from a pool of ``pool`` clips of speech-like audio made in
    set-up, taken in an order the seed shuffles."""

    def __init__(self, traffic: dict, seed: int, device):
        pool, frames, hop = int(traffic["pool"]), int(traffic["frames"]), int(traffic["hop"])
        audio = speech_like(pool, frames * hop, generator(seed, "audio")).numpy()
        spec = stft_features(audio, int(traffic["n_fft"]), hop, frames)
        self.specs = torch.from_numpy(spec).to(device)
        self.batch = int(traffic["batch"])
        self.rng = np.random.default_rng(stream_seed(seed, "order"))
        self.order = np.empty(0, np.int64)

    def next_call(self) -> torch.Tensor:
        """The indices into the pool of the next call's spectrograms."""
        while self.order.size < self.batch:
            self.order = np.concatenate([self.order, self.rng.permutation(len(self.specs))])
        idx, self.order = self.order[: self.batch], self.order[self.batch:]
        return torch.from_numpy(idx)


# ---- training batches ------------------------------------------------------------------------
class TrainBatches:
    """Pairs of (clean, noisy) crops resident on the device; each step takes
    ``batch`` rows, every row of a pass over the pool once, in an order the
    seed shuffles."""

    def __init__(self, traffic: dict, seed: int, num_samples: int, device):
        rows = int(traffic["pool_rows"])
        clean, noisy = noisy_pair(rows, num_samples, generator(seed, "audio", device),
                                  snr_grid(rows, traffic))
        self.clean, self.noisy = clean[:, None], noisy[:, None]
        self.batch = int(traffic["batch"])
        self.gen = generator(seed, "order", device)
        self.order = torch.empty(0, dtype=torch.long, device=device)

    def next_rows(self) -> torch.Tensor:
        if self.order.numel() < self.batch:
            perm = torch.randperm(self.clean.shape[0], generator=self.gen,
                                  device=self.clean.device)
            self.order = torch.cat([self.order, perm])
        idx, self.order = self.order[: self.batch], self.order[self.batch:]
        return idx
