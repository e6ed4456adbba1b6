"""The benchmark's harness: finds a cell's pieces by name, runs it once and
prints its result.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name in
``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration as it is run (the
  program's config dict) with its ``source``, ``reduced`` and ``assumed``;
- ``benchmark/reference/<config>.py``: its plain reference;
- ``benchmark/traffic/<traffic>.json``: the parameters of a traffic mix,
  whose ``kind`` names the driver (``benchmark/cells.py``);
- ``benchmark/layer_metrics/<metric>.py``: the reader of one per-layer
  metric, ``read(ctx)`` returning a number or None when it finds nothing;
- ``benchmark/limits/<workload>.json``: the limit of every number the
  cell's outputs are held to, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sddm_tpu")
TRACE_SECONDS = 4.0  # the longest traced window


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path

    @property
    def reference(self):
        return load_file(self.root / "benchmark" / "reference" / f"{self.config_name}.py")


def load_file(path: Path):
    """A Python file as a module of its own (names may hold dots and dashes)."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_of(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``spec`` with its files read."""
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r}; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    # a per-layer metric applies where listed, else wherever the metric it moves is reported
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (_applies(m, workload) if "workloads" in m else m["moves"] in e2e_names)]
    limits_path = root / "benchmark" / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json")
                                   .read_text()),
                end_to_end=e2e, per_layer=layer, limits=limits, root=root)


def reader_of(cell: Cell, metric: str):
    return load_file(cell.root / "benchmark" / "layer_metrics" / f"{metric}.py")


def value_of(name: str, values: dict):
    """A driver's value of the end-to-end metric ``name``: under that name,
    or, for a metric ``<quantity>.<regime>`` (the same quantity in cells
    that want a bound of their own), under ``<quantity>``."""
    return values.get(name, values.get(name.split(".")[0]))


def forbidden_loaded() -> list:
    """Modules of JAX or of the JAX package in ``sys.modules``, compared by
    whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---- one run ------------------------------------------------------------------------
def run(cell: Cell, seed: int, seconds: float, trace: bool, device, mesh=None, t0=None,
        faults=(), ctl=None) -> dict:
    """Set up, measure (or trace) and check one run of ``cell``.  ``t0``:
    the wall time the run's process started (set-up counts from there);
    ``ctl``: a host process group over the ranks of a mesh, through which
    they agree when a window ends; ``faults``: planted under the timed path
    (the harness's tests).  Returns the result's fields; on a mesh, only
    rank 0's are whole."""
    import torch

    import sddm_tpu_torch  # noqa: F401  (the system under test: no run without it)
    from benchmark import tracing
    from benchmark.cells import KINDS

    t0 = time.time() if t0 is None else t0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    driver = KINDS[cell.traffic["kind"]](cell, seed, device, mesh, faults)
    driver.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    stop = _agree(ctl, all) if ctl is not None else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    result = {"metrics": {}, "device": {}}
    if not trace:
        driver.window(seconds, stop)
        metrics = driver.end_to_end()
        metrics["setup_s"] = setup_s
        for m in cell.end_to_end:
            value = value_of(m["name"], metrics)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        net = driver.trace_network()
        driver.trace_wrap()
        events = []
        any_rank = _agree(ctl, any) if ctl is not None else (lambda flag: flag)
        for margin, with_cpu in tracing.retry_windows():
            counter = tracing.ForwardCounter(net)
            driver.forwards = counter
            n0 = driver.done()
            with tracing.profiled(margin, with_cpu) as prof:
                driver.window(min(seconds, TRACE_SECONDS), stop)
            counter.remove()
            events = tracing.device_events(prof)
            if not any_rank(not events):
                break
        driver.end_to_end()
        busy = tracing.busy_s(events)
        ctx = dict(driver.layer_context(driver.done() - n0), events=events, spans=driver.spans,
                   window_s=driver.window_s, busy_s=busy, chips=cell.chips)
        ctx["peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
        for m in cell.per_layer:
            value = reader_of(cell, m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        busy, window_s = _mean(ctl, busy), _mean(ctl, driver.window_s)
        result["device"].update(busy_s=busy, window_s=window_s)
        names = tracing.time_by_name(events)
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in
                           sorted(names.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": tracing.idle_gaps(events, driver.spans)}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    result["device"].update(platform="gpu", count=cell.chips,
                            kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                            memory_peak_bytes=int(_max(ctl, peak)))
    result["attempted"], result["failed"] = driver.attempted, driver.failed
    driver.release()
    checks = driver.checks() if driver.main else {}
    if ctl is not None:
        _barrier(ctl)
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k, {}).get("limit")}
                        for k, v in checks.items()}
    result["correct"] = bool(driver.main and result["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in result["checks"].values()))
    if getattr(driver, "engine_fallback", None):
        result["engine_fallback"] = driver.engine_fallback
    return result


def _agree(ctl, how):
    """A function of this rank's flag that returns the ranks' verdict
    (``all`` or ``any`` of their flags), through the host group ``ctl``."""
    import torch
    import torch.distributed as dist

    def verdict(flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MIN if how is all else dist.ReduceOp.MAX, group=ctl)
        return bool(t.item())

    return verdict


def _reduce(ctl, value: float, op) -> float:
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=op, group=ctl)
    return float(t.item())


def _max(ctl, value):
    if ctl is None:
        return value
    import torch.distributed as dist

    return _reduce(ctl, value, dist.ReduceOp.MAX)


def _mean(ctl, value):
    if ctl is None:
        return value
    import torch.distributed as dist

    return _reduce(ctl, value, dist.ReduceOp.SUM) / dist.get_world_size(ctl)


def _barrier(ctl):
    import torch.distributed as dist

    dist.barrier(group=ctl)


# ---- output -------------------------------------------------------------------------
ORDER = ("correct", "attempted", "failed", "metrics", "device", "breakdown")


def emit(result: dict) -> int:
    """Print the numbers compared beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    the numbers compared under ``checks``, last.  Refuses (exit 3, no
    result) where JAX or the JAX package was loaded."""
    found = forbidden_loaded()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr, flush=True)
        return 3
    line = {k: result[k] for k in ORDER if k in result}
    line["checks"] = result["checks"]
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
