"""Time the NCHW GroupNorm+SiLU backward kernel of this checkout beside the
two-launch design it replaced, site by site, on one card.

    python -m sddm_tpu_torch.compare_gn_silu_backward --earlier PATH [--json FILE]

``PATH`` is the earlier design's ``csrc/gn_silu_bwd.cu``: one CTA a (row,
group) run making three passes over it from device memory, then a second
launch for dweight and dbias; its launchers take the CTA size, not a plan
(for example ``git show <commit>:sddm_tpu_torch/csrc/gn_silu_bwd.cu``).  Both
sources are built with nvcc (``ops/cuda_build.py``).  At each of the 19
distinct GroupNorm sites of the flagship's plain network, batch 16, bf16,
both kernels run on the same seeded inputs; each call's dweight and dbias are
held against ``gn_silu_backward_reference`` (5e-6 of the scale + 1e-5 of the
value, as chip_smoke.py phase [23]); each kernel is timed by the profiler's
device time over 5 calls after 3 warm-up calls, in the order earlier,
current, current, earlier, and the faster reading of each is kept.  Prints a
line a site, the sums over a train step's 33 sites, the card's name and
power limit, and writes the readings as JSON to ``--json``.  Exits non-zero
when there is no card, a build fails or a result disagrees.
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
# the earlier launchers: x, dy, w, b, dx, part, dw, db, B, C, HW, G, eps, threads, stream
_EARLIER_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]


def earlier_threads(hw: int) -> int:
    """The earlier design's CTA: a thread a position of a channel, in whole
    warps, up to 512."""
    return min(512, -(-hw // 32) * 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="the two-launch design's gn_silu_bwd.cu")
    ap.add_argument("--json", type=Path, default=None, help="write the readings here")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sddm_tpu_torch.ops import cuda_build
    from sddm_tpu_torch.ops.gn_silu import gn_silu_backward, gn_silu_backward_reference

    if not torch.cuda.is_available():
        print("no CUDA device: this comparison runs on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    lib = ctypes.CDLL(str(cuda_build.build(args.earlier.resolve())["path"]))
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

    def device_us(fn, calls=5):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler once returned no device events for a window
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and "gn_silu_bwd" in e.key)
            if us:
                return us / calls
        raise RuntimeError("the profiler saw no backward kernel")

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
        e1 = device_us(lambda: earlier(x, dy, wt, bt, g))
        c1 = device_us(lambda: gn_silu_backward(x, dy, wt, bt, g))
        c2 = device_us(lambda: gn_silu_backward(x, dy, wt, bt, g))
        e2 = device_us(lambda: earlier(x, dy, wt, bt, g))
        row = {"site": [BATCH, c, h, w], "groups": g, "calls_a_step": count,
               "earlier_us": min(e1, e2), "current_us": min(c1, c2),
               "readings_us": [e1, c1, c2, e2]}
        rows.append(row)
        print(f"[{BATCH},{c},{h},{w}] G={g} x{count}: earlier {row['earlier_us']:.1f} us, "
              f"current {row['current_us']:.1f} us ({row['current_us'] / row['earlier_us']:.2f}); "
              f"readings {e1:.1f} {c1:.1f} {c2:.1f} {e2:.1f}")
    step = {k: sum(r[k] * r["calls_a_step"] for r in rows) / 1e3
            for k in ("earlier_us", "current_us")}
    slower = [r["site"] for r in rows if r["current_us"] > r["earlier_us"]]
    print(f"a train step's 33 sites: earlier {step['earlier_us']:.4f} ms, current "
          f"{step['current_us']:.4f} ms; sites where the current kernel is slower: {slower}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "sites": rows, "step_ms": step,
                                         "slower": slower}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
