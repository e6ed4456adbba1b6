"""Score a results directory, or summarize its saved vectors (counterpart
of the root ``evaluate_results.py``, same argument and flags).

Usage: python -m sddm_tpu_torch.evaluate_results <samples dir> [--load] [--plot]
"""

import argparse
import logging

from .evaluate import evaluate, load_results


def main(argv=None) -> dict:
    """Parse ``argv`` and run; returns what ``evaluate`` or ``load_results``
    returned."""
    parser = argparse.ArgumentParser(description="Evaluate enhancement results")
    parser.add_argument("samples_path", type=str, help="dir containing target/ condition/ output/")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--metrics", nargs="+", default=["pesq_wb", "stoi", "sisnr"])
    parser.add_argument("--load", action="store_true",
                        help="summarize previously saved metric vectors")
    parser.add_argument("--plot", action="store_true",
                        help="with --load: save best-improvement waveform figures")
    args = parser.parse_args(argv)

    logger = logging.getLogger("evaluate")
    if args.load:
        summary = load_results(args.samples_path, args.metrics, plot=args.plot,
                               sample_rate=args.sample_rate)
        for m, vals in summary.items():
            logger.info("%s: %s", m, vals)
        return summary
    return evaluate(args.samples_path, ".wav", args.sample_rate, set(args.metrics), logger)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
