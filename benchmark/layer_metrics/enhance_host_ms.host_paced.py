"""The same reading as ``enhance_host_ms``, in the cells whose rate the host paces
(they report ``serve_audio_s_per_s.host_paced``)."""

from pathlib import Path

from benchmark.harness import load_file

read = load_file(Path(__file__).with_name("enhance_host_ms.py")).read
