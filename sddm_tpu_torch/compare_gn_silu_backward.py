"""Time a GroupNorm+SiLU backward kernel of this checkout beside the design it
replaced, site by site, on one card.

    python -m sddm_tpu_torch.compare_gn_silu_backward --earlier PATH [--json FILE]
    python -m sddm_tpu_torch.compare_gn_silu_backward --layout nhwc --earlier PATH [--json FILE]

``--layout nchw`` (the default): ``PATH`` is the earlier NCHW design's
``csrc/gn_silu_bwd.cu``: one CTA a (row, group) run making three passes over
it from device memory, then a second launch for dweight and dbias; its
launchers take the CTA size, not a plan (for example ``git show
<commit>:sddm_tpu_torch/csrc/gn_silu_bwd.cu``).  At each of the 19 distinct
GroupNorm sites of the flagship's plain network, batch 16, bf16, both kernels
run on the same seeded inputs; each call's dweight and dbias are held against
``gn_silu_backward_reference`` (5e-6 of the scale + 1e-5 of the value, as
chip_smoke.py phase [23]); each kernel is timed by the profiler's device time
over 5 calls after 3 warm-up calls.

``--layout nhwc``: ``PATH`` is the earlier NHWC design's
``csrc/gn_silu_nhwc_bwd.cu``: two plain launches a call (``nhwc_bwd_sums``,
then ``nhwc_bwd_dx``), reading x and dy twice (``git show
951b5bf:sddm_tpu_torch/csrc/gn_silu_nhwc_bwd.cu``); this module keeps a copy
of its plan, :func:`earlier_nhwc_plan`.  At each of the 33 GroupNorm sites of
the flagship's packed engine (``artifacts/flagship_synth``), batch 16, bf16,
in a train step's order, both kernels run on the same seeded inputs with the
statistics the forward kernel wrote; each call's dx (one bf16 ulp + 5e-6 of
the scale), dscale and dbias (5e-6 of the scale + 1e-5 of the value) are held
against ``gn_silu_nhwc_backward_reference``, as chip_smoke.py phase [30];
each kernel is timed by the profiler's device time (every launch of a call)
over 5 calls after 3 warm-up calls, and by CUDA events over 20 calls.

Both sources are built with nvcc (``ops/cuda_build.py``).  The kernels are
timed in the order earlier, current, current, earlier, and the faster
reading of each is kept.  Prints a line a site, the sums over a train step's
33 sites, the card's name and power limit, and writes the readings as JSON
to ``--json``.  Exits non-zero when there is no card, a build fails or a
result disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (C, H, W, G) of the flagship's plain network (artifacts/flagship_synth), as
# chip_smoke.py phase [3] lists them, with the calls of a train step at each
FLAGSHIP_SITES = {
    (64, 256, 128, 32): 1, (32, 256, 128, 32): 4, (128, 128, 64, 32): 1,
    (64, 128, 64, 32): 2, (32, 128, 64, 32): 3, (192, 64, 32, 32): 1, (128, 64, 32, 32): 1,
    (96, 64, 32, 32): 1, (64, 64, 32, 32): 3, (256, 32, 16, 32): 1, (192, 32, 16, 32): 1,
    (128, 32, 16, 32): 1, (96, 32, 16, 32): 3, (320, 16, 8, 32): 1, (256, 16, 8, 32): 1,
    (160, 16, 8, 32): 1, (128, 16, 8, 32): 3, (320, 8, 4, 32): 1, (160, 8, 4, 32): 3,
}
BATCH = 16
FLAGSHIP_RUN = Path(__file__).resolve().parent.parent / "artifacts" / "flagship_synth"
# the earlier NCHW launchers: x, dy, w, b, dx, part, dw, db, B, C, HW, G, eps, threads, stream
_EARLIER_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
# the earlier NHWC launchers: x, dy, scale, bias, group_of, order, stats, dx, work, dscale,
# dbias, B, H, W, C4, G, K, rows, grid, smem, n, offset, eps, stream
_EARLIER_NHWC_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def earlier_threads(hw: int) -> int:
    """The earlier NCHW design's CTA: a thread a position of a channel, in
    whole warps, up to 512."""
    return min(512, -(-hw // 32) * 32)


def earlier_nhwc_plan(b: int, h: int, w: int, c4: int, groups: int, elem: int, sms: int):
    """The earlier NHWC design's plan (its ``nhwc_backward_plan``): ``(k,
    rows, grid, smem, work)``: k ranges a row, as many as give the card up
    to two 512-thread blocks an SM, at most 32, none under 16 KB of x; one
    ``nhwc_bwd_sums`` block an item, then as many ``nhwc_bwd_dx`` blocks and
    one a 16 channels of dscale and dbias."""
    hw, row_bytes = h * w, c4 * elem
    k = max(1, min(2 * sms // b, 32, -(-hw * row_bytes // 16384), hw))
    rows = -(-hw // k)
    k = -(-hw // rows)
    items = b * k
    smem = -(-4 * (2 * c4 + 4 * groups + groups + 1 + c4) // 16) * 16
    return k, rows, items + -(-c4 // 16), smem, items * 2 * c4


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _device_us(fn, match, calls: int = 5) -> float:
    """The profiler's device time of one call of ``fn``: every launch whose
    kernel name ``match`` accepts, over ``calls`` calls after 3 warm-up
    calls; a window that saw none of them is profiled again, with the
    margins of ``utils/profiling.RETRY_WINDOWS`` in turn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.utils.profiling import RETRY_WINDOWS, profiled

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for margin, with_cpu in RETRY_WINDOWS:
        activities = (ProfilerActivity.CPU,) * with_cpu + (ProfilerActivity.CUDA,)
        with profiled(*activities, margin_s=margin) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and match(e.key))
        if us:
            return us / calls
    raise RuntimeError("the profiler saw no backward kernel")


def _events_us(fn, calls: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / calls


def compare_nchw(earlier_path: Path):
    """(rows, ok) of the NCHW comparison."""
    import torch

    from sddm_tpu_torch.ops import cuda_build
    from sddm_tpu_torch.ops.gn_silu import gn_silu_backward, gn_silu_backward_reference

    lib = ctypes.CDLL(str(cuda_build.build(earlier_path)["path"]))
    earlier_fn = lib.gn_silu_bwd_bf16
    earlier_fn.argtypes, earlier_fn.restype = _EARLIER_ARGS, ctypes.c_int
    device = torch.device("cuda")

    def earlier(x, dy, w, b, g):
        bsz, c, h, ww = x.shape
        dx = torch.empty_like(x)
        part = torch.empty(2 * bsz * c, dtype=torch.float32, device=device)
        dw = torch.empty(c, dtype=torch.float32, device=device)
        db = torch.empty(c, dtype=torch.float32, device=device)
        rc = earlier_fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), b.data_ptr(), dx.data_ptr(),
                        part.data_ptr(), dw.data_ptr(), db.data_ptr(), bsz, c, h * ww, g, 1e-5,
                        earlier_threads(h * ww), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier kernel failed: CUDA error {rc}")
        return dx, dw, db

    def is_bwd(key):
        return "gn_silu_bwd" in key

    gen = torch.Generator(device=device).manual_seed(0)
    rows, ok = [], True
    for (c, h, w, g), count in FLAGSHIP_SITES.items():
        x = torch.randn((BATCH, c, h, w), device=device, generator=gen).to(torch.bfloat16)
        dy = torch.randn_like(x)
        wt = torch.rand(c, device=device, generator=gen) + 0.5
        bt = 0.1 * torch.randn(c, device=device, generator=gen)
        want = gn_silu_backward_reference(x, dy, wt, bt, g)
        for name, fn in (("earlier", earlier), ("current", gn_silu_backward)):
            for got, ref in zip(fn(x, dy, wt, bt, g)[1:], want[1:]):
                scale = float(ref.abs().max())
                if not bool(torch.all((got - ref).abs() <= 5e-6 * scale + 1e-5 * ref.abs())):
                    print(f"{name} kernel disagrees with the plain backward at {(c, h, w, g)}")
                    ok = False
        e1 = _device_us(lambda: earlier(x, dy, wt, bt, g), is_bwd)
        c1 = _device_us(lambda: gn_silu_backward(x, dy, wt, bt, g), is_bwd)
        c2 = _device_us(lambda: gn_silu_backward(x, dy, wt, bt, g), is_bwd)
        e2 = _device_us(lambda: earlier(x, dy, wt, bt, g), is_bwd)
        row = {"site": [BATCH, c, h, w], "groups": g, "calls_a_step": count,
               "earlier_us": min(e1, e2), "current_us": min(c1, c2),
               "readings_us": [e1, c1, c2, e2]}
        rows.append(row)
        print(f"[{BATCH},{c},{h},{w}] G={g} x{count}: earlier {row['earlier_us']:.1f} us, "
              f"current {row['current_us']:.1f} us ({row['current_us'] / row['earlier_us']:.2f}); "
              f"readings {e1:.1f} {c1:.1f} {c2:.1f} {e2:.1f}")
    return rows, ok


def packed_sites(device):
    """[(the _GN module, (H, W, C4))] of one forward of the flagship's packed
    engine (random weights: the sites' shapes and group maps are the
    configuration's), in call order."""
    import torch

    from sddm_tpu_torch.models import PackedUNetModified2, UNetModified2
    from sddm_tpu_torch.models.unet_packed import _GN

    config = json.loads((FLAGSHIP_RUN / "config.json").read_text())
    net_args = {k: v for k, v in config["network"]["args"].items() if k != "dropout"}
    n = config["num_samples"]
    engine = PackedUNetModified2(UNetModified2(num_samples=n, **net_args).to(device))
    sites = []
    hooks = [m.register_forward_pre_hook(lambda m, a: sites.append((m, tuple(a[0].shape[1:]))))
             for m in engine.modules() if isinstance(m, _GN)]
    with torch.no_grad():
        z = torch.zeros(1, 1, n, device=device)
        engine(z, z, torch.ones(1, 1, 1, device=device))
    for h in hooks:
        h.remove()
    return sites


def compare_nhwc(earlier_path: Path):
    """(rows, ok) of the NHWC comparison."""
    import torch

    from sddm_tpu_torch.ops import cuda_build
    from sddm_tpu_torch.ops.gn_silu import (
        _divisor,
        _sm_count,
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
        gn_silu_nhwc_backward_reference,
        group_order,
        nhwc_backward_plan_of,
    )
    from sddm_tpu_torch.ops.packed import offset_mask

    lib = ctypes.CDLL(str(cuda_build.build(earlier_path)["path"]))
    earlier_fn = lib.gn_silu_nhwc_bwd_bf16
    earlier_fn.argtypes, earlier_fn.restype = _EARLIER_NHWC_ARGS, ctypes.c_int
    device = torch.device("cuda")
    sms = _sm_count(device)

    def earlier(x, dy, sc, bi, group_of, groups, count, offset, order, stats):
        b, h, w, c4 = x.shape
        k, rows, grid, smem, work_n = earlier_nhwc_plan(b, h, w, c4, groups, 2, sms)
        dx = torch.empty_like(x)
        work = torch.empty(work_n, dtype=torch.float32, device=device)
        dscale = torch.empty(c4, dtype=torch.float32, device=device)
        dbias = torch.empty(c4, dtype=torch.float32, device=device)
        rc = earlier_fn(x.data_ptr(), dy.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                        group_of.data_ptr(), order.data_ptr(), stats.data_ptr(), dx.data_ptr(),
                        work.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), b, h, w, c4,
                        groups, k, rows, grid, smem, _divisor(h, w, count, offset), int(offset),
                        1e-5, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier kernel failed: CUDA error {rc}")
        return dx, dscale, dbias

    def current(x, dy, sc, bi, group_of, groups, count, offset, order, stats):
        return gn_silu_nhwc_backward(x, dy, sc, bi, group_of, groups, count, offset,
                                     order=order, stats=stats)

    def is_bwd(key):
        return "nhwc_bwd_" in key

    gen = torch.Generator(device=device).manual_seed(0)
    rows, ok = [], True
    for m, (h, w, c4) in packed_sites(device):
        shape = (BATCH, h, w, c4)
        x = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
        if m.offset:  # the engine zeroes the out-of-range rows/cols before the GN
            x *= torch.from_numpy(offset_mask(h, w, c4 // 4)).to(device, x.dtype)
        dy = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
        sc = (torch.rand(c4, device=device, generator=gen) + 0.5).contiguous()
        bi = (0.1 * torch.randn(c4, device=device, generator=gen)).contiguous()
        order = group_order(m.group_of, m.groups)
        stats = torch.empty((BATCH, m.groups, 2), dtype=torch.float32, device=device)
        gn_silu_nhwc(x, sc, bi, m.group_of, m.groups, m.count, m.offset, order=order,
                     stats=stats)
        args = (x, dy, sc, bi, m.group_of, m.groups, m.count, m.offset, order, stats)
        want = gn_silu_nhwc_backward_reference(*args[:8])
        for name, fn in (("earlier", earlier), ("current", current)):
            for out, got, ref in zip(("dx", "dscale", "dbias"), fn(*args), want):
                got, ref = got.float(), ref.float()
                scale = float(ref.abs().max())
                rtol = 2.0**-7 if out == "dx" else 1e-5
                if not bool(torch.all((got - ref).abs() <= 5e-6 * scale + rtol * ref.abs())):
                    print(f"{name} kernel's {out} disagrees with the plain backward at {shape}")
                    ok = False
        e1 = _device_us(lambda: earlier(*args), is_bwd)
        c1 = _device_us(lambda: current(*args), is_bwd)
        c2 = _device_us(lambda: current(*args), is_bwd)
        e2 = _device_us(lambda: earlier(*args), is_bwd)
        ev = [_events_us(lambda: earlier(*args)), _events_us(lambda: current(*args)),
              _events_us(lambda: current(*args)), _events_us(lambda: earlier(*args))]
        plan = nhwc_backward_plan_of(x, m.groups)
        row = {"site": list(shape), "groups": m.groups, "offset": bool(m.offset),
               "earlier_us": min(e1, e2), "current_us": min(c1, c2),
               "readings_us": [e1, c1, c2, e2],
               "earlier_events_us": min(ev[0], ev[3]), "current_events_us": min(ev[1], ev[2]),
               "events_readings_us": ev, "waves": plan.waves, "calls_a_step": 1}
        rows.append(row)
        print(f"{str(list(shape)):22s} {'offset' if m.offset else 'plain ':6s} device: earlier "
              f"{row['earlier_us']:6.1f} us, current {row['current_us']:6.1f} us "
              f"({row['current_us'] / row['earlier_us']:.2f}); events: earlier "
              f"{row['earlier_events_us']:6.1f} us, current {row['current_events_us']:6.1f} us; "
              f"waves {plan.waves}; device readings {e1:.1f} {c1:.1f} {c2:.1f} {e2:.1f}")
    return rows, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="the earlier design's source (gn_silu_bwd.cu or gn_silu_nhwc_bwd.cu)")
    ap.add_argument("--layout", choices=("nchw", "nhwc"), default="nchw",
                    help="which backward to compare (default nchw)")
    ap.add_argument("--json", type=Path, default=None, help="write the readings here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this comparison runs on the card", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}")
    compare = compare_nhwc if args.layout == "nhwc" else compare_nchw
    rows, ok = compare(args.earlier.resolve())
    keys = ["earlier_us", "current_us"]
    if args.layout == "nhwc":
        keys += ["earlier_events_us", "current_events_us"]
    step = {k: sum(r[k] * r["calls_a_step"] for r in rows) / 1e3 for k in keys}
    slower = [r["site"] for r in rows if r["current_us"] > r["earlier_us"]]
    print(f"a train step's 33 sites, device time: earlier {step['earlier_us']:.4f} ms, current "
          f"{step['current_us']:.4f} ms; sites where the current kernel is slower: {slower}")
    if args.layout == "nhwc":
        print(f"the same by CUDA events: earlier {step['earlier_events_us']:.4f} ms, current "
              f"{step['current_events_us']:.4f} ms")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "layout": args.layout, "sites": rows,
                                         "step_ms": step, "slower": slower}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
