"""Generate the reproducible synthetic speech-shaped corpus (counterpart of
the root ``make_synthetic_corpus.py``, same flags).  Deterministic in
--seed; the test split is written with ``seed + 1`` and the hard split
with ``seed + 2``.

Usage: python -m sddm_tpu_torch.make_synthetic_corpus --root data/synth --n-train 2000 --n-test 200
"""

import argparse
import os

from .data.synth import generate_corpus


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="data/synth")
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-test", type=int, default=200)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--version", type=int, default=2, choices=(1, 2),
                    help="2 (default): STOI-meaningful speech-shaped v2; "
                    "1: the round-1..3 corpus")
    ap.add_argument("--hard-split", action="store_true",
                    help="also generate <root>/test_hard/: the test recipe "
                    "at a 10 dB lower SNR grid (-7.5..7.5)")
    ap.add_argument("--hard-only", action="store_true",
                    help="generate ONLY the test_hard split (corpus exists)")
    ap.add_argument("--subset-first", type=int, default=0, metavar="N",
                    help="also create <root>/trainN/ symlinking the first N "
                    "sorted train files")
    args = ap.parse_args(argv)

    if not args.hard_only:
        generate_corpus(os.path.join(args.root, "train"), args.n_train,
                        seed=args.seed, split="train", version=args.version)
        generate_corpus(os.path.join(args.root, "test"), args.n_test,
                        seed=args.seed + 1, split="test", version=args.version)
        print(f"corpus at {args.root}: {args.n_train} train / "
              f"{args.n_test} test (v{args.version})")
    if args.hard_split or args.hard_only:
        generate_corpus(os.path.join(args.root, "test_hard"), args.n_test,
                        seed=args.seed + 2, split="test_hard", version=args.version)
        print(f"hard split at {args.root}/test_hard: {args.n_test} files "
              f"(SNR grid -7.5..7.5 dB)")

    if args.subset_first:
        src = os.path.join(args.root, "train")
        dst = os.path.join(args.root, f"train{args.subset_first}")
        names = sorted(n for n in os.listdir(os.path.join(src, "clean"))
                       if n.endswith(".wav"))[: args.subset_first]
        for side in ("clean", "noisy"):
            os.makedirs(os.path.join(dst, side), exist_ok=True)
            for n in names:
                p = os.path.join(dst, side, n)
                if os.path.lexists(p):  # a dangling link from an earlier root
                    os.unlink(p)
                os.symlink(os.path.abspath(os.path.join(src, side, n)), p)
            for n in os.listdir(os.path.join(dst, side)):  # drop stale extras
                if n.endswith(".wav") and n not in names:
                    os.unlink(os.path.join(dst, side, n))
        print(f"subset at {dst}: first {len(names)} sorted train files")


if __name__ == "__main__":
    main()
