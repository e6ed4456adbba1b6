"""Host-side scoring of a results directory (counterpart of
``sddm_tpu/evaluate.py``).

``evaluate`` walks a ``samples/`` dir of target/condition/output WAV
triplets, scores every file by SI-SNR, STOI and PESQ, logs the noisy and
output averages, and saves the per-file vectors as ``output_<m>.npy`` and
``noisy_<m>.npy``.  PESQ wraps the C ``pesq`` library when it is importable;
without it ``pesq_wb``/``pesq_nb`` are reported as ``pesq_wb_approx`` /
``pesq_nb_approx`` (``ops/pesq_approx.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from .data.datasets import OutputDataset
from .ops.stoi import stoi as _stoi


def sisnr_np(s_hat: np.ndarray, s: np.ndarray) -> float:
    s_hat = np.asarray(s_hat, np.float64).reshape(-1)
    s = np.asarray(s, np.float64).reshape(-1)
    s_hat = s_hat - s_hat.mean()
    s = s - s.mean()
    s_target = (np.dot(s_hat, s) / (np.dot(s, s) + 1e-12)) * s
    e_noise = s_hat - s_target
    return float(10 * np.log10(np.dot(s_target, s_target) / (np.dot(e_noise, e_noise) + 1e-12)))


def _pesq_fn(mode: str):
    try:
        from pesq import pesq as pesq_lib  # C library, host-side
    except ImportError:
        return None

    def run(s_hat, s, sample_rate):
        return float(pesq_lib(sample_rate, np.asarray(s).reshape(-1),
                              np.asarray(s_hat).reshape(-1), mode))

    return run


def make_evaluators(sample_rate: int):
    """``{metric: fn(output, reference) -> float}``: ``sisnr``, ``stoi``, and
    ``pesq_wb``/``pesq_nb`` from the C library or else their ``_approx``."""
    from .ops.pesq_approx import pesq_approx

    evaluators = {
        "sisnr": lambda out, ref: sisnr_np(out, ref),
        "stoi": lambda out, ref: _stoi(ref, out, sample_rate),
    }
    for name, mode in (("pesq_wb", "wb"), ("pesq_nb", "nb")):
        fn = _pesq_fn(mode)
        if fn is not None:
            evaluators[name] = lambda out, ref, _fn=fn: _fn(out, ref, sample_rate)
        else:
            evaluators[f"{name}_approx"] = (
                lambda out, ref, _m=mode: pesq_approx(ref, out, sample_rate, _m))
    return evaluators


def evaluate(samples_path, datatype: str, sample_rate: int, metrics: Iterable[str],
             logger: Optional[logging.Logger] = None) -> dict:
    """Returns ``{metric: {"noisy": avg, "output": avg}}`` and saves per-file
    vectors as ``output_<m>.npy`` / ``noisy_<m>.npy`` in ``samples_path``."""
    logger = logger or logging.getLogger(__name__)
    samples_path = Path(samples_path)
    dataset = OutputDataset(samples_path, datatype, sample_rate)
    evaluators = make_evaluators(sample_rate)

    available = []
    for m in metrics:
        if m in evaluators:
            available.append(m)
        elif f"{m}_approx" in evaluators:
            logger.warning("certified '%s' unavailable (missing host C library); "
                           "reporting '%s_approx' (P.862-style approximation) instead", m, m)
            available.append(f"{m}_approx")
        else:
            logger.warning("metric '%s' unavailable (missing host library); skipping", m)

    n = len(dataset)
    noisy_vec = np.zeros((len(available), n))
    output_vec = np.zeros((len(available), n))
    for i in range(n):
        clean, noisy, output = dataset[i]
        # trim to the common length (padding differences at chunk boundaries)
        ln = min(clean.shape[-1], noisy.shape[-1], output.shape[-1])
        c, ny, o = clean[..., :ln], noisy[..., :ln], output[..., :ln]
        for j, m in enumerate(available):
            try:
                output_vec[j, i] = evaluators[m](o, c)
                noisy_vec[j, i] = evaluators[m](ny, c)
            except Exception:  # one file's failure scores 0 and the run goes on
                logger.warning("metric %s failed for %s", m, dataset.get_name(i), exc_info=True)

    results = {}
    for j, m in enumerate(available):
        results[m] = {"noisy": float(np.mean(noisy_vec[j])),
                      "output": float(np.mean(output_vec[j]))}
        logger.info("%s:", m)
        logger.info("Average for noisy: %s", results[m]["noisy"])
        logger.info("Average for output: %s", results[m]["output"])
        np.save(samples_path / f"output_{m}.npy", output_vec[j])
        np.save(samples_path / f"noisy_{m}.npy", noisy_vec[j])
    return results


def load_results(samples_path, metrics, plot: bool = False, sample_rate: int = 16000) -> dict:
    """Summaries of saved vectors.  With ``plot=True``, saves a
    clean/noisy/denoised waveform figure of the best-improvement utterance
    per metric as ``best_<m>.png`` in the samples dir."""
    samples_path = Path(samples_path)
    out = {}
    for m in metrics:
        output_v = np.load(samples_path / f"output_{m}.npy")
        noisy_v = np.load(samples_path / f"noisy_{m}.npy")
        improvement = output_v - noisy_v
        best_idx = int(improvement.argmax())
        out[m] = {
            "output_mean": float(output_v.mean()),
            "noisy_mean": float(noisy_v.mean()),
            "max_improvement": float(improvement.max()),
            "max_improvement_index": best_idx,
        }
        if plot:
            _plot_best(samples_path, m, best_idx, sample_rate)
    return out


def _plot_best(samples_path: Path, metric: str, idx: int, sample_rate: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    clean, noisy, output = OutputDataset(samples_path, ".wav", sample_rate)[idx]
    t = np.arange(clean.shape[-1]) / sample_rate
    fig, axs = plt.subplots(3, 1, sharex=True, figsize=(10, 6))
    plt.subplots_adjust(hspace=0.4)
    for ax, (sig, title) in zip(axs, [(clean, "Clean Speech"), (noisy, "Noisy Speech"),
                                      (output, "De-noised Speech")]):
        ax.plot(t, sig.reshape(-1), linewidth=0.5)
        ax.set_ylabel("Amplitude")
        ax.set_title(title)
    axs[2].set_xlabel("Time, s")
    fig.savefig(samples_path / f"best_{metric}.png", dpi=120)
    plt.close(fig)
