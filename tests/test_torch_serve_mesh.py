"""Serving over the data mesh: the port's ``load_enhancer`` under 1, 2 and 4
gloo CPU ranks against its single-process serve and against JAX's
``load_enhancer`` sharded over the 8 CPU devices of the root conftest.

The ranks are launched once a world size (``python -m
sddm_tpu_torch.parallel.dryrun --serve``), all three at once, and serve the
same requests case by case: the packed engine at ancestral-3, DDIM at eta
0.5 (a draw every step), the plain network, a ``batch_rows`` the ranks do not
divide, ``validate_packed=False`` on a checkpoint with a NaN weight, and a
canary made to fail on the last rank only.  Each rank draws the whole
batch's noise from the shared generator and samples its rows, so every rank
gives the single-process serve's outputs: bit for bit at one rank; at 2 and
4 ranks the network runs at another row count, whose float32 rounding can
differ in the last bits, so rtol 1e-5, atol 1e-6 (the reading is printed).
JAX's serve draws its noise from its key; here both packages take the same
injected noise, drawn from a torch generator in the sampler's order, and
agree at the sampler's tolerance of ``tests/test_torch_enhance.py`` (rtol
1e-4, atol 1e-4).
"""

import concurrent.futures
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from sddm_tpu.models import SDDM as JaxSDDM
from sddm_tpu.models import UNetModified2 as JaxUNet
from sddm_tpu.train.checkpoints import save_checkpoint
from sddm_tpu_torch import enhance as tenh
from sddm_tpu_torch.models import SDDM
from sddm_tpu_torch.parallel import Mesh, all_finite, gather_rows, make_mesh
from sddm_tpu_torch.parallel.dryrun import TINY, serve_inputs, serve_parity, tiny_flagship
from sddm_tpu_torch.train.trainer import init_parameters

NS = 72
T = 8
STEPS = 3
ROWS = 8  # batch_rows: 1, 2 and 4 ranks divide it, as JAX's 8 devices do
NET = dict(inner_channel=8, norm_groups=4, channel_mults=[1, 2], res_blocks=1,
           segment_len=16, segment_stride=8)
SCHED = dict(schedule="linear", n_timestep=T, linear_start=1e-4, linear_end=0.05)
CONFIG = {
    "num_samples": NS,
    "arch": {"type": "SDDM", "args": {"p_transition": "condition_in"}},
    "diffusion": {"type": "GaussianDiffusion", "args": SCHED},
    "network": {"type": "UNetModified2", "args": dict(NET, in_channel=2, out_channel=1,
                                                       dropout=0)},
    "packed": True,
}
DDIM_ETA = {"arch": {"type": "SDDM", "args": {"p_transition": "ddim", "ddim_eta": 0.5}}}
LENGTHS = (100, 300, 217)  # 2 + 5 + 4 = 11 rows: two batches of 8, the second padded
WORLDS = (1, 2, 4)
RTOL, ATOL = 1e-5, 1e-6


def _cases(ckpts, n):
    good, nan = (str(p) for p in ckpts)
    return [
        dict(name="packed", checkpoint=good, batch_rows=ROWS, steps=STEPS, seed=5),
        dict(name="ddim_eta", checkpoint=good, batch_rows=ROWS, steps=STEPS, seed=6,
             config=DDIM_ETA),
        dict(name="plain", checkpoint=good, batch_rows=ROWS, steps=STEPS, seed=7, packed=False),
        dict(name="nondividing", checkpoint=good, batch_rows=3, steps=STEPS, seed=8,
             warmup_timeout_s=120.0),
        dict(name="unvalidated", checkpoint=nan, batch_rows=ROWS, steps=STEPS, seed=9,
             validate_packed=False),
        dict(name="canary_last_rank", checkpoint=good, batch_rows=ROWS, steps=STEPS, seed=7,
             fail_canary_rank=n - 1),
    ]


@pytest.fixture(autouse=True, scope="module")
def _global_rng_kept():
    """Modules built here draw their default init from torch's global
    generator; the files run after this one in a worker find it as it was."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(3)
    return [rng.uniform(-0.4, 0.4, n).astype(np.float32) for n in LENGTHS]


@pytest.fixture(scope="module")
def params():
    jnet = JaxUNet(num_samples=NS, **NET)
    return jax.tree_util.tree_map(np.asarray, JaxSDDM(JaxSchedule.create(**SCHED), jnet)
                                  .init(jax.random.PRNGKey(0), (1, 1, NS)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, params):
    """The tiny flagship's checkpoint, written by the JAX package, and a copy
    with a NaN bias."""
    work = tmp_path_factory.mktemp("serve_ckpts")
    poisoned = jax.tree_util.tree_map(np.array, params)
    poisoned["params"]["Block_0"]["Conv_0"]["bias"][0] = np.nan
    paths = (work / "model_best.ckpt", work / "nan.ckpt")
    for path, p in zip(paths, (params, poisoned)):
        save_checkpoint(path, arch="SDDM", epoch=1, params=p, opt_state={}, monitor_best=0.0,
                        config=CONFIG)
    return paths


@pytest.fixture(scope="module")
def launched(tmp_path_factory, ckpts, requests):
    """The three launches (1, 2 and 4 ranks), started together; each entry a
    future of :func:`serve_parity`'s record."""
    work = tmp_path_factory.mktemp("serve_mesh")
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(serve_parity,
                              serve_inputs(work / f"in{n}.npz", CONFIG, requests,
                                           _cases(ckpts, n)),
                              work / f"out{n}", n, timeout=300)
               for n in WORLDS}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def single(ckpts, requests):
    """Each case served in this process without a process group, on one
    intra-op thread as the ranks run (the CPU's convolutions sum in another
    order on several)."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case in _cases(ckpts, 1)[:4]:
            out[case["name"]] = _serve_in_process(case, requests)
    finally:
        torch.set_num_threads(threads)
    return out


def _serve_in_process(case, requests):
    enh = tenh.load_enhancer(case["checkpoint"], {**CONFIG, **case.get("config", {})},
                             batch_rows=case["batch_rows"], steps=STEPS,
                             packed=case.get("packed", True), device="cpu")
    assert not enh.mesh.distributed and not enh.sharded
    enh.generator = torch.Generator().manual_seed(case["seed"])
    return enh.enhance_batch(requests)


def _torch_draws(seed: int, batches: int, steps: int):
    """The ancestral sampler's draws for ``batches`` batches of ``ROWS``
    rows from a CPU generator seeded ``seed``, in its order: x_T, then one
    a step, batch after batch."""
    gen = torch.Generator().manual_seed(seed)
    shape = (ROWS, 1, NS)
    out = []
    for _ in range(batches):
        xT = torch.randn(shape, generator=gen).numpy()
        out.append((xT, np.stack([torch.randn(shape, generator=gen).numpy()
                                  for _ in range(steps)])))
    return out


def test_ranks_match_jax_load_enhancer_on_its_8_device_mesh(launched, ckpts, requests,
                                                          tmp_path, monkeypatch):
    """JAX's ``load_enhancer`` on the config without ``"packed"`` (its packed
    engine; with the key its loader cannot serve, see
    ``tests/test_torch_enhance.py``) shards each batch of 8 rows over its 8
    CPU devices; its sampler takes the same injected draws as the port's
    ranks drew from their generator seeded 5, batch by batch."""
    from sddm_tpu.enhance import load_enhancer as jax_load_enhancer

    monkeypatch.setenv("SDDM_COMPILE_CACHE", os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                                            str(tmp_path / "jax_cache")))
    jenh = jax_load_enhancer(ckpts[0], {k: v for k, v in CONFIG.items() if k != "packed"},
                             batch_rows=ROWS, steps=STEPS)
    assert jenh.mesh.devices.size == 8 and ROWS % jenh.mesh.devices.size == 0
    infer = jax.jit(jenh.model.infer)
    draws = iter(_torch_draws(5, 2, STEPS))
    shapes = []

    def injected(params, key, cond):
        shapes.append(cond.sharding.shard_shape(cond.shape))
        xT, steps = next(draws)
        return infer(params, key, cond, noise_stream=(jnp.asarray(xT), jnp.asarray(steps)))

    jenh._infer = injected
    want = jenh.enhance_batch(requests)
    assert shapes == [(1, 1, NS)] * 2  # one row on each of the 8 devices, two batches
    for n in WORLDS:
        record = launched[n].result()["packed"]
        assert [r["sharded"] for r in record["ranks"]] == [n > 1] * n
        for outs in record["outputs"]:
            for g, w in zip(outs, want):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _close(got, want, label):
    worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"{label}: max |d| {worst:.3e} against the single-process serve")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return worst


@pytest.mark.parametrize("name", ["packed", "ddim_eta", "plain"])
@pytest.mark.parametrize("n", WORLDS)
def test_ranks_serve_the_single_process_outputs(launched, single, n, name):
    """Every rank returns the whole served batch, its own rows sampled on
    ``ROWS / n`` rows and the rest gathered: the outputs of one process."""
    record = launched[n].result()[name]
    engine = "UNetModified2" if name == "plain" else "PackedUNetModified2"
    assert [r["engine"] for r in record["ranks"]] == [engine] * n
    assert [r["rows"] for r in record["ranks"]] == [ROWS // n] * n
    assert [r["sharded"] for r in record["ranks"]] == [n > 1] * n
    first = record["outputs"][0]
    for outs in record["outputs"][1:]:  # the same bits on every rank
        for a, b in zip(outs, first):
            np.testing.assert_array_equal(a, b)
    if n == 1:
        for g, w in zip(first, single[name]):
            np.testing.assert_array_equal(g, w)
    else:
        _close(first, single[name], f"{name} over {n} ranks")


@pytest.mark.parametrize("n", WORLDS)
def test_non_dividing_batch_is_served_whole_on_every_rank(launched, single, n):
    """``batch_rows`` 3 over 2 or 4 ranks: each rank samples the whole batch,
    as JAX serves a batch its mesh does not divide; the warmup ran within its
    limit and returned its seconds."""
    record = launched[n].result()["nondividing"]
    assert [(r["sharded"], r["rows"]) for r in record["ranks"]] == [(False, 3)] * n
    assert all(r["warmup_s"] > 0 for r in record["ranks"])
    for outs in record["outputs"]:
        for g, w in zip(outs, single["nondividing"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", WORLDS)
def test_validate_packed_false_serves_the_engine_unchecked(launched, n):
    """A NaN weight fails the canary (``tests/test_torch_enhance.py``);
    without the canary the packed engine is served all the same."""
    record = launched[n].result()["unvalidated"]
    assert [(r["engine"], r["engine_fallback"]) for r in record["ranks"]] == \
        [("PackedUNetModified2", None)] * n


@pytest.mark.parametrize("n", WORLDS)
def test_canary_failing_on_one_rank_falls_back_on_every_rank(launched, single, n):
    """The last rank's canary is made to fail: the verdict is reduced over
    the world, so every rank serves the plain network, and the gathered
    batch is one engine's (the plain serve from the same seed)."""
    record = launched[n].result()["canary_last_rank"]
    assert [(r["engine"], r["engine_fallback"]) for r in record["ranks"]] == \
        [("UNetModified2", "canary")] * n
    for outs in record["outputs"]:
        if n == 1:
            for g, w in zip(outs, single["plain"]):
                np.testing.assert_array_equal(g, w)
        else:
            _close(outs, single["plain"], f"canary fallback over {n} ranks")


@pytest.mark.parametrize("n", WORLDS)
def test_cpu_ranks_touch_no_card(launched, n):
    """Under ``--device cpu`` every rank serves on the CPU over gloo and
    never initialises CUDA."""
    for records in launched[n].result().values():
        for r in records["ranks"]:
            assert (r["device"], r["backend"], r["cuda_initialized"]) == ("cpu", "gloo", False)
            assert r["ranks"] == n
            assert r["launches"] == {"gn_silu_nhwc": 0, "gn_silu": 0}  # the plain versions


def _tiny(**arch):
    model = tiny_flagship()
    init_parameters(model.network, torch.Generator().manual_seed(0))
    model.network.eval()
    return SDDM(model.diffusion, model.network, **arch)


@pytest.mark.parametrize("arch,steps,eta", [
    (dict(p_transition="original"), 0, None),
    (dict(p_transition="condition_in"), 3, None),
    (dict(p_transition="sr3"), 0, None),
    (dict(p_transition="supportive"), 0, None),
    (dict(p_transition="conditional", q_transition="conditional"), 0, None),
    (dict(p_transition="conditional", q_transition="conditional"), 3, 0.5),
    (dict(p_transition="condition_in"), 3, 0.0),
    (dict(p_transition="ddim", ddim_eta=0.5), 0, None),
], ids=["original", "condition_in_3", "sr3", "supportive", "conditional",
        "ddim_conditional_eta", "ddim_3", "ddim_eta"])
def test_noise_stream_reproduces_the_samplers_draws(arch, steps, eta):
    """``draw_noise_stream`` makes the draws ``infer`` makes, bit for bit, and
    leaves the generator where ``infer`` leaves it; cut to rows, it gives
    those rows of the whole batch's chain."""
    model = _tiny(**arch)
    if eta is not None:
        model = model.with_ddim(eta)
    if steps:
        model = model.with_sampling_steps(steps)
    cond = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (4, 1, TINY["num_samples"]))
                            .astype(np.float32))
    gen_a, gen_b = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    want = model.infer(cond, gen_a)
    got = model.infer(cond, noise_stream=model.draw_noise_stream(cond.shape, gen_b))
    assert torch.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.equal(torch.randn(8, generator=gen_a), torch.randn(8, generator=gen_b))
    rows = model.infer(cond[1:3], noise_stream=model.draw_noise_stream(
        cond.shape, torch.Generator().manual_seed(11), cut=lambda t: t[1:3]))
    np.testing.assert_allclose(rows.numpy(), want[1:3].numpy(), rtol=RTOL, atol=ATOL)


def test_step_draws_are_made_in_order_once():
    model = _tiny(p_transition="condition_in").with_sampling_steps(2)
    _, steps = model.draw_noise_stream((1, 1, 4), torch.Generator().manual_seed(0))
    assert len(steps) == 2
    with pytest.raises(IndexError, match="in order"):
        steps[1]
    assert [tuple(steps[i].shape) for i in (0, 1)] == [(1, 1, 4)] * 2
    with pytest.raises(IndexError, match="in order"):
        steps[2]


class _Sleeper:
    """A stand-in sampler that takes ``seconds`` a call."""

    def __init__(self, seconds):
        self.seconds, self.calls = seconds, []
        self.network = torch.nn.Linear(1, 1)

    def infer(self, condition, *args, **kwargs):
        self.calls.append(tuple(condition.shape))
        time.sleep(self.seconds)
        return condition


def test_warmup_returns_seconds_and_raises_after_its_limit():
    """As JAX's ``Enhancer.warmup`` (``tests/test_enhance.py``): one call at
    the serving shape, its seconds returned; past ``timeout_s`` a
    ``TimeoutError`` with a diagnostic, also from the constructor."""
    fast = _Sleeper(0.01)
    enh = tenh.Enhancer(fast, NS, batch_rows=2)
    assert enh.warmup() >= 0.01 and enh.warmup(timeout_s=30) >= 0.01
    assert fast.calls == [(2, 1, NS)] * 2
    enh.generator = torch.Generator().manual_seed(0)
    state = enh.generator.get_state()
    enh.warmup()
    assert torch.equal(enh.generator.get_state(), state)  # the served draws stay as they were
    with pytest.raises(TimeoutError, match="did not finish in 0.1 s"):
        tenh.Enhancer(_Sleeper(2.0), NS, batch_rows=2).warmup(timeout_s=0.1)
    with pytest.raises(TimeoutError, match="warmup"):
        tenh.Enhancer(_Sleeper(2.0), NS, batch_rows=2, warmup=True, warmup_timeout_s=0.1)


def test_without_a_process_group_the_helpers_return_their_input():
    mesh = make_mesh(device="cpu")
    assert mesh == Mesh((("data", 1),), 0, torch.device("cpu"))
    x = torch.arange(6.0).reshape(3, 2)
    assert gather_rows(x, mesh) is x
    assert all_finite(True, mesh) is True and all_finite(False, mesh) is False
    enh = tenh.Enhancer(_Sleeper(0.0), NS, batch_rows=4)
    assert enh.mesh == mesh and not enh.sharded


def test_enhancer_refuses_a_model_axis():
    mesh = Mesh((("data", 1), ("model", 2)), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="no model axis"):
        tenh.Enhancer(_Sleeper(0.0), NS, batch_rows=4, mesh=mesh)


def test_loader_under_torchrun_without_a_card_raises(monkeypatch):
    """No card and no ``device="cpu"``: the loader refuses before it starts
    a process group, as ``resolve_device`` refuses without ``torchrun``."""
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenh.load_enhancer("unused.ckpt", CONFIG)
    assert not torch.distributed.is_initialized()
