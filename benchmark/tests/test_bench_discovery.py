"""A configuration, a traffic mix and a per-layer metric that exist only as
new files and new ``BENCHMARK.json`` entries are found by name, in a copy
of the benchmark in a temporary directory (discovery and traffic
generation; no timing)."""

from __future__ import annotations

import json
import shutil

import numpy as np

from benchmark import harness, inputs
from benchmark.cells import Train


def copy_of_benchmark(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_config_traffic_and_metric_by_files_alone(tmp_path):
    root = copy_of_benchmark(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "unet-modified2-flagship.json").read_text())
    cfg["network"]["args"]["res_blocks"] = 2
    (bench / "configs" / "unet-modified2-deep.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "reference" / "unet-modified2-flagship.py",
                bench / "reference" / "unet-modified2-deep.py")
    traffic = json.loads((bench / "traffic" / "enhance-r256.json").read_text())
    traffic.update(batch_rows=16, fill_rows=16)
    traffic["lengths"].update(median_s=1.2, max_s=2.0, grid=64)
    (bench / "traffic" / "enhance-short-r16.json").write_text(json.dumps(traffic))
    (bench / "layer_metrics" / "calls_per_window.serve.py").write_text(
        "def read(ctx):\n    return ctx['calls'] / ctx['window_s'] if ctx['calls'] else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "unet-modified2-deep", "source": "https://example.org/x",
                            "file": "benchmark/configs/unet-modified2-deep.json",
                            "reduced": [], "why": "two res blocks a level"})
    spec["workloads"].append({"name": "enhance-deep-short-r16", "config": "unet-modified2-deep",
                              "traffic": "enhance-short-r16", "chips": 1, "why": "short"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "enhance-flagship-r256" in m["workloads"]:
            m["workloads"].append("enhance-deep-short-r16")
    spec["per_layer"].append({"name": "calls_per_window.serve", "unit": "1/s",
                              "better": "higher", "source": "program_counter",
                              "layer": "serving API", "moves": "serve_audio_s_per_s",
                              "workloads": ["enhance-deep-short-r16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.cell_of(harness.load_spec(root), "enhance-deep-short-r16", root)
    assert cell.config["network"]["args"]["res_blocks"] == 2 and cell.chips == 1
    assert cell.traffic["batch_rows"] == 16
    assert {m["name"] for m in cell.end_to_end} == {"serve_audio_s_per_s", "serve_p95_ms",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["calls_per_window.serve"]
    reader = harness.reader_of(cell, "calls_per_window.serve")
    assert reader.read({"calls": 6, "window_s": 2.0}) == 3.0
    assert reader.read({"calls": 0, "window_s": 2.0}) is None
    assert len(cell.reference.norm_sites(cell.config, 1)) == 2 * 2 * 5 + 2 + 3 * 2 * 5 + 1

    requests = inputs.EnhanceRequests(cell.traffic, 7, cell.config["num_samples"])
    for _ in range(20):
        call = requests.next_call()
        rows = sum(-(-a.size // cell.config["num_samples"]) for _, a in call)
        assert call and rows <= 16
        assert all(16000 <= a.size <= 32000 for _, a in call)


def test_every_cell_of_the_benchmark_is_whole():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.cell_of(spec, w["name"])
        assert cell.traffic["kind"] in ("enhance", "vocode", "train")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert hasattr(harness.reader_of(cell, m["name"]), "read")
        compared = {"train": set(Train.COMPARED)}.get(cell.traffic["kind"], {"out_rel_l2_max"})
        assert set(cell.limits) >= compared
        assert all(np.isfinite(v["limit"]) for v in cell.limits.values())


def test_a_regime_metric_reads_its_quantity():
    """``<quantity>.<regime>`` (a cell's own bound for the same quantity)
    reads the driver's ``<quantity>``; its own name comes first."""
    values = {"serve_audio_s_per_s": 3.0, "setup_s": 9.0}
    assert harness.value_of("serve_audio_s_per_s.host_paced", values) == 3.0
    assert harness.value_of("serve_audio_s_per_s", values) == 3.0
    assert harness.value_of("setup_s", values) == 9.0
    assert harness.value_of("train_audio_s_per_s.host_paced", values) is None
    assert harness.value_of("serve_audio_s_per_s.host_paced",
                            dict(values, **{"serve_audio_s_per_s.host_paced": 2.0})) == 2.0
