"""The same reading as ``denoiser_replay_share``, in the cells whose rate the
host paces (they report ``serve_audio_s_per_s.host_paced``)."""

from pathlib import Path

from benchmark.harness import load_file

read = load_file(Path(__file__).with_name("denoiser_replay_share.py")).read
