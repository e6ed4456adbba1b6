#!/usr/bin/env python3
"""Drive the PyTorch port (``sddm_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card: name, nvidia-smi name and power limit, versions;
  2. build the CUDA GroupNorm+SiLU kernel with nvcc (build time and the
     ``-Xptxas -v`` summary);
  3. hold the kernel against its plain PyTorch version at every GroupNorm
     site of the flagship network, batch 16, in float32 and bfloat16, plus an
     odd shape (unaligned path) and a near-constant group (variance clamp);
  4. load the committed flagship checkpoint through ``load_enhancer`` at
     ancestral-12 (the serving recipe, bfloat16 compute);
  5. serve four seeded noisy requests as one ``enhance_batch``: shapes,
     trims, finiteness, the clip bound, and ``gn_silu.launches`` equal to
     33 sites x 12 steps x batches;
  6. serve them again through the plain GroupNorm+SiLU with the same weights
     and noise stream, in bfloat16 and in float32, and hold the kernel path
     against it; one float32 forward on the card against the CPU;
  7. time the kernel, its plain version and the two-call
     ``F.silu(F.group_norm(...))`` at the largest site with CUDA events,
     beside the bound of the bytes it must move, and the kernel and plain
     version at every site;
  8. profile one served batch: device busy time by kernel, and the idle
     share against the unprofiled serve time of phase 5 (the profiler's own
     host cost inflates its wall time; both are printed).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN = ROOT / "artifacts" / "flagship_synth"
SEED = 0
BATCH_ROWS = 16
STEPS = 12
SITES_PER_FORWARD = 33
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernel vs plain version, elementwise: |got - want| <= atol + rtol * |want|.
# float32: the statistics are summed in another order (last-bit differences).
# bfloat16: one bf16 ulp (2**-7 relative), as either side may round the same
# f32 value the other way, plus 1e-5 where the output is near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0**-7)}
# served waveforms, kernel path vs plain path with the same weights and noise
# stream, as (max |d|, relative L2).  Both paths are deterministic, so the
# difference is the kernel's rounding carried through 12 steps.  On H100
# 80GB HBM3 cards at 700 W three runs read bf16 max |d| 1.9e-3 and rel L2
# 4.2e-3, f32 max |d| 4.2e-7 and rel L2 6.3e-7; each limit is its reading
# times 2.5 to 5.
E2E_TOL = {"bfloat16": (5e-3, 2e-2), "float32": (2e-6, 3e-6)}
# one float32 forward on the card (TF32 off) vs the CPU: the CPU port
# matches JAX to 1e-3 (tests/test_torch_checkpoint.py); the same bound here.
CARD_VS_CPU_TOL = 1e-3


def log(msg: str = "") -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def close_enough(got, want, atol: float, rtol: float):
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    return ok, float(err.max())


@contextlib.contextmanager
def plain_gn_silu():
    """Route every GroupNormSiLU module to ``gn_silu_reference``, the plain
    version the kernel is held against, for the duration of the block."""
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.ops.gn_silu import gn_silu, gn_silu_reference

    blocks.gn_silu = gn_silu_reference
    try:
        yield
    finally:
        blocks.gn_silu = gn_silu


def requests(n: int = 4):
    """Seeded noisy requests of 1-3 s at 16 kHz: harmonic tones under a
    syllable-rate envelope plus white noise at 5 dB SNR."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    out = []
    for length in (17011, 30977, 46301, 23456)[:n]:
        t = np.arange(length) / 16000.0
        f0 = rng.uniform(100, 250)
        clean = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k
                    for k in range(1, 6))
        clean *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t)) * 0.1
        noise = rng.standard_normal(length)
        noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** 0.5)
        out.append((clean + noise).astype(np.float32))
    return out


def main() -> int:
    import numpy as np
    import torch

    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "sddm_tpu_torch").is_dir() or not (RUN / "model_best.ckpt").is_file():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import sddm_tpu_torch
    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.models import UNetModified2
    from sddm_tpu_torch.models.blocks import GroupNormSiLU
    from sddm_tpu_torch.ops.gn_silu import build, gn_silu, gn_silu_reference

    if Path(sddm_tpu_torch.__file__).resolve().parent != ROOT / "sddm_tpu_torch":
        fail(f"imported sddm_tpu_torch from {sddm_tpu_torch.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device: {kind} | nvidia-smi: {smi} | count {torch.cuda.device_count()}")
    log(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # -- 2. build -----------------------------------------------------------
    built = build()
    log(f"[2] build: {built['path'].name} in {built['seconds']:.2f} s"
        f"{' (cached)' if built['cached'] else ''}")
    for line in built["log"].splitlines():
        if any(k in line for k in ("Compiling entry", "Used", "spill", "stack frame")):
            log(f"    ptxas: {line.strip()}")

    # -- 3. kernel vs plain at every flagship site ----------------------------
    config = json.loads((RUN / "config.json").read_text())
    net_args = {k: v for k, v in config["network"]["args"].items() if k != "dropout"}
    probe = UNetModified2(num_samples=config["num_samples"], **net_args).to(device).eval()
    sites = []

    def record(module, args):
        sites.append((tuple(args[0].shape[1:]), module.num_groups))

    hooks = [m.register_forward_pre_hook(record)
             for m in probe.modules() if isinstance(m, GroupNormSiLU)]
    with torch.no_grad(), plain_gn_silu():
        z = torch.zeros(1, 1, config["num_samples"], device=device)
        probe(z, z, torch.ones(1, 1, 1, device=device))
    for h in hooks:
        h.remove()
    del probe
    if len(sites) != SITES_PER_FORWARD:
        fail(f"expected {SITES_PER_FORWARD} GroupNorm sites per forward, found {len(sites)}")
    distinct = sorted(set(sites), key=lambda s: -math.prod(s[0]))
    log(f"[3] {len(sites)} GroupNorm+SiLU sites per forward, {len(distinct)} distinct "
        f"(C, H, W), G; checking each at batch {BATCH_ROWS}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    cases = [((BATCH_ROWS,) + chw, g, 1.0) for chw, g in distinct]
    cases += [((3, 12, 7, 5), 4, 1.0),       # cg 3, H*W = 35: the unaligned path
              ((2, 16, 8, 8), 16, 1e-3)]     # near-constant groups at 1000
    for shape, g, spread in cases:
        c = shape[1]
        w = (1 + 0.5 * torch.randn(c, device=device, generator=gen)).contiguous()
        b = (0.2 * torch.randn(c, device=device, generator=gen)).contiguous()
        x32 = torch.randn(shape, device=device, generator=gen) * 2 * spread
        x32 += (1000.0 if spread < 1 else 0.3) + 0.5 * torch.randn(
            (1, c, 1, 1), device=device, generator=gen)
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = x32.to(dtype).contiguous()
            got = gn_silu(x, w, b, g)
            want = gn_silu_reference(x, w, b, g)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape or not torch.isfinite(got).all():
                fail(f"kernel output at {shape} {dtype_name}: dtype {got.dtype}, "
                     f"finite {bool(torch.isfinite(got).all())}")
            if spread < 1:  # the clamp case: finite is the check
                continue
            ok, err = close_enough(got, want, *TOL[dtype_name])
            max_err[dtype_name] = max(max_err[dtype_name], err)
            log(f"    {str(shape):22s} G={g:<3d} {dtype_name:8s} max|d|={err:.3e} "
                f"{'ok' if ok else 'OVER'} (atol, rtol {TOL[dtype_name]})")
            if not ok:
                fail(f"kernel disagrees with gn_silu_reference at {shape} {dtype_name}")

    # -- 4. load the flagship through the port ------------------------------
    t0 = time.perf_counter()
    enh = load_enhancer(RUN / "model_best.ckpt", config, batch_rows=BATCH_ROWS, steps=STEPS)
    torch.cuda.synchronize()
    net = enh.model.network
    log(f"[4] load_enhancer(steps={STEPS}) on {enh.device}: {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in net.parameters())} params, compute {net.dtype}, "
        f"{enh.model.num_timesteps} steps")
    if enh.model.num_timesteps != STEPS or net.dtype != torch.bfloat16:
        fail("the served model is not the bf16 ancestral-12 recipe")

    # -- 5. serve ------------------------------------------------------------
    audios = requests()
    n_rows = sum(math.ceil(a.size / config["num_samples"]) for a in audios)
    n_batches = math.ceil(n_rows / BATCH_ROWS)

    def serve(seed):
        enh.generator = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = enh.enhance_batch(audios)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    _, warm_s = serve(SEED + 1)  # cuDNN autotuning and allocator warm-up
    torch.cuda.reset_peak_memory_stats()
    gn_silu.launches = 0
    served, serve_s = serve(SEED)
    launches = gn_silu.launches
    peak = torch.cuda.max_memory_allocated()
    audio_s = sum(a.size for a in audios) / config["sample_rate"]
    log(f"[5] served {len(audios)} requests ({audio_s:.2f} s of audio, {n_rows} rows, "
        f"{n_batches} batches): warm-up {warm_s:.3f} s, timed {serve_s:.3f} s "
        f"(RTF {serve_s / audio_s:.4f}), gn_silu.launches {launches}, "
        f"peak {peak / 2**20:.1f} MiB")
    for a, y in zip(audios, served):
        if y.shape != a.shape or not np.isfinite(y).all() or np.abs(y).max() > 1.0:
            fail(f"served output shape {y.shape} for input {a.shape}, "
                 f"finite {np.isfinite(y).all()}")
    expected = SITES_PER_FORWARD * STEPS * n_batches
    if launches != expected:
        fail(f"gn_silu.launches = {launches}, expected {expected} "
             f"({SITES_PER_FORWARD} sites x {STEPS} steps x {n_batches} batches)")

    # -- 6. the same requests through the plain GroupNorm+SiLU ----------------
    e2e = {}
    for dtype in (torch.bfloat16, torch.float32):
        net.dtype = dtype
        kernel_out, kernel_s = served, serve_s
        if dtype != torch.bfloat16:
            serve(SEED + 1)  # cuDNN picks its float32 algorithms
            kernel_out, kernel_s = serve(SEED)
        with plain_gn_silu():
            plain_out, plain_s = serve(SEED)
        name = str(dtype).split(".")[-1]
        err = max(float(np.abs(k - p).max()) for k, p in zip(kernel_out, plain_out))
        rel = math.sqrt(sum(float(np.sum((k - p) ** 2)) for k, p in zip(kernel_out, plain_out))
                        / sum(float(np.sum(p**2)) for p in plain_out))
        e2e[name] = {"max_abs": err, "rel_l2": rel, "kernel_s": kernel_s, "plain_s": plain_s}
        tol_abs, tol_rel = E2E_TOL[name]
        log(f"[6] {name}: kernel path vs plain path, same weights and noise: "
            f"max|d|={err:.3e} (tol {tol_abs}) rel_l2={rel:.3e} (tol {tol_rel}); "
            f"serve {kernel_s:.3f} s vs {plain_s:.3f} s")
        if not (err <= tol_abs and rel <= tol_rel):
            fail(f"{name} served output differs from the plain path: max|d| {err}, "
                 f"rel_l2 {rel}")
    net.dtype = torch.float32
    rng = np.random.default_rng(SEED)
    n = config["num_samples"]
    cond = (0.1 * rng.standard_normal((1, 1, n))).astype(np.float32)
    x_t = (0.8 * cond + 0.3 * rng.standard_normal((1, 1, n))).astype(np.float32)
    level = np.full((1, 1, 1), 0.95, np.float32)
    with torch.no_grad():
        on_card = net(*(torch.from_numpy(a).to(device) for a in (cond, x_t, level)))
        cpu_net = UNetModified2(num_samples=n, **net_args).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        on_cpu = cpu_net(*(torch.from_numpy(a) for a in (cond, x_t, level)))
    card_cpu_err = float((on_card.cpu() - on_cpu).abs().max())
    log(f"    float32 forward, card (kernel) vs CPU (plain): max|d|={card_cpu_err:.3e} "
        f"(tol {CARD_VS_CPU_TOL})")
    if not card_cpu_err <= CARD_VS_CPU_TOL:
        fail(f"card forward differs from the CPU forward by {card_cpu_err}")
    net.dtype = torch.bfloat16

    # -- 7. timing at the largest site --------------------------------------
    (c, h, w_), g = distinct[0]
    shape = (BATCH_ROWS, c, h, w_)
    x = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
    wt = torch.rand(c, device=device, generator=gen) + 0.5
    bt = torch.randn(c, device=device, generator=gen) * 0.1
    kernel_ms = cuda_time_ms(lambda: gn_silu(x, wt, bt, g))
    plain_ms = cuda_time_ms(lambda: gn_silu_reference(x, wt, bt, g))
    two_call_ms = cuda_time_ms(lambda: F.silu(F.group_norm(x, g, wt.to(x.dtype),
                                                           bt.to(x.dtype), 1e-5)))
    kernel_ms2 = cuda_time_ms(lambda: gn_silu(x, wt, bt, g))
    n_el = x.numel()
    bytes_moved = 2 * n_el * x.element_size() + 2 * c * 4
    ops = 10 * n_el  # about ten float32 operations per element (sums, affine, SiLU)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    site_ms = {}
    for (cs, hs, ws), gs in distinct:
        xs = torch.randn((BATCH_ROWS, cs, hs, ws), device=device,
                         generator=gen).to(torch.bfloat16)
        ones, zeros = torch.ones(cs, device=device), torch.zeros(cs, device=device)
        site_ms[(cs, hs, ws, gs)] = (cuda_time_ms(lambda: gn_silu(xs, ones, zeros, gs), 20),
                                     cuda_time_ms(lambda: gn_silu_reference(xs, ones, zeros, gs), 20))
    per_forward = [sum(site_ms[chw + (gs,)][i] for chw, gs in sites) for i in (0, 1)]
    log(f"[7] {shape} bf16 G={g}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.silu(F.group_norm) {two_call_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved} B at 3.35 TB/s); "
        f"{bytes_moved / kernel_ms / 1e6:.0f} GB/s")
    for (cs, hs, ws, gs), (k_ms, p_ms) in site_ms.items():
        log(f"    site [{BATCH_ROWS},{cs},{hs},{ws}] G={gs}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"{sites.count(((cs, hs, ws), gs))} per forward")
    log(f"    all {len(sites)} sites of one batch-{BATCH_ROWS} forward: kernel {per_forward[0]:.3f} ms, "
        f"plain {per_forward[1]:.3f} ms; no single PyTorch call computes GroupNorm+SiLU "
        f"(library_ms null; the two-call time is two_call_ms)")

    # -- 8. where the time goes: one served batch under the profiler ----------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enh.generator = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        enh.enhance_batch(audios)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - start) * 1e3
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in device_events}
    busy_ms = sum(busy.values())
    gn_ms = sum(v for k, v in busy.items() if "gn_silu" in k)
    idle_share = 1 - busy_ms / (serve_s * 1e3)
    if busy_ms > 0:
        log(f"[8] profiled serve of the same batch: device busy {busy_ms:.1f} ms, idle share "
            f"{idle_share:.3f} of the unprofiled serve ({serve_s * 1e3:.1f} ms, phase 5); "
            f"{1 - busy_ms / prof_wall_ms:.3f} of the profiled wall ({prof_wall_ms:.1f} ms); "
            f"gn_silu kernel {gn_ms:.2f} ms ({gn_ms / busy_ms:.3f} of busy)")
        for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
            n_calls = next(e.count for e in device_events if e.key == name)
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{n_calls:<5d} {name[:90]}")
    else:
        log("[8] the profiler saw no device time: breakdown not measured")

    record_line = {"kernels": [{
        "name": "gn_silu",
        "route": "cuda",
        "source": "sddm_tpu_torch/csrc/gn_silu.cu",
        "replaces": "sddm_tpu/experimental/pallas_groupnorm_swish.py:98",
        "launches": launches,
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_f32": max_err["float32"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "two_call_ms": two_call_ms,
        "shape": list(shape),
        "dtype": "bfloat16",
        "sites_per_forward_ms": per_forward[0],
        "plain_sites_per_forward_ms": per_forward[1],
    }], "serve": {"requests": len(audios), "rows": n_rows, "steps": STEPS,
                  "seconds": serve_s, "audio_seconds": audio_s, "peak_bytes": peak,
                  "e2e": e2e, "card_vs_cpu_f32": card_cpu_err,
                  "profile": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                              "idle_share": idle_share, "gn_silu_ms": gn_ms}},
        "build_seconds": built["seconds"], "nvidia_smi": smi}
    log(smi)
    print(json.dumps(record_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
