"""The packed engine's CUDA graph (``PackedUNetModified2.forward``) on the CPU:
its caches, which forwards take the graph and which stay eager, and the
dispatch around the capture with the capture replaced by a stub graph whose
replay runs the captured body on the static inputs, as a graph would.  The
card's own checks (the graphed forward and ``SDDM.infer`` bit for bit
against the eager ones) are ``chip_smoke.py``'s."""

import numpy as np
import pytest
import torch

from sddm_tpu_torch.diffusion.schedule import DiffusionSchedule
from sddm_tpu_torch.models import PackedTrainUNetModified2, PackedUNetModified2, UNetModified2
from sddm_tpu_torch.models import unet_packed
from sddm_tpu_torch.models.sddm import SDDM
from sddm_tpu_torch.models.unet_variable import UNetModified2_VariableNoiseLevel
from sddm_tpu_torch.models.unet_variable_packed import PackedTrainUNetVariable, PackedUNetVariable
from sddm_tpu_torch.ops import gn_silu as gn_ops
from sddm_tpu_torch.utils import profiling

NS = 72  # 8 frames of 16 at stride 8
NET = dict(num_samples=NS, inner_channel=8, norm_groups=4, channel_mults=(1, 2), res_blocks=1,
           segment_len=16, segment_stride=8)
VAR_NET = dict(inner_channel=8, norm_groups=4, channel_mults=[1, 2], res_blocks=1,
               noise_level_channel=16, dropout=0)


def engine(cls=PackedUNetModified2):
    torch.manual_seed(0)
    return cls(UNetModified2(**NET).eval()).eval()


def inputs(rows: int = 2, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    cond = 0.1 * torch.randn((rows, 1, NS), generator=g)
    x_t = torch.randn((rows, 1, NS), generator=g)
    level = 0.3 + 0.6 * torch.rand((rows, 1, 1), generator=g)
    return cond, x_t, level


class StubGraph:
    """Stands in for a CUDA graph: capture runs the body once (the static
    output), a replay runs it again on the static inputs into that output,
    with the launch counter left as it was (a replay does not pass through
    the wrappers)."""

    def __init__(self, body):
        self.body, self.replays = body, 0
        self.out = body()

    def replay(self):
        self.replays += 1
        before = gn_ops.gn_silu_nhwc.launches
        self.out.copy_(self.body())
        gn_ops.gn_silu_nhwc.launches = before


@pytest.fixture
def stub(monkeypatch):
    """Every tensor counts as on a card; captures make :class:`StubGraph`s
    (the list of them is returned)."""
    made = []

    def capture(body):
        made.append(StubGraph(body))
        return made[-1], made[-1].out

    monkeypatch.setattr(unet_packed, "_on_card", lambda t: True)
    monkeypatch.setattr(unet_packed, "_cuda_graph", capture)
    return made


@pytest.fixture
def counted(monkeypatch):
    """The NHWC site function, in both modules, counting its calls in
    ``launches`` as the kernel's wrapper does."""
    plain = gn_ops.gn_silu_nhwc

    def fn(*args, **kwargs):
        fn.launches += 1
        return plain(*args, **kwargs)

    fn.launches = 0
    monkeypatch.setattr(gn_ops, "gn_silu_nhwc", fn)
    monkeypatch.setattr(unet_packed, "gn_silu_nhwc", fn)
    return fn


# -- the caches ------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_the_kept_encoding_equals_the_per_call_tensor(dt):
    eng = engine()
    half = NET["inner_channel"] // 2
    step = np.arange(half, dtype=np.float32)
    per_call = torch.as_tensor(1e4 * 10.0 ** (-step * 4.0 / half), dtype=dt)
    kept = eng._encoding(dt, torch.device("cpu"))
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    assert kept.dtype == dt and torch.equal(kept.view(bits), per_call.view(bits))
    assert eng._encoding(dt, torch.device("cpu")) is kept
    eng.pack()
    assert eng._encoding(dt, torch.device("cpu")) is not kept


def test_prepare_keeps_one_tree_until_pack_or_a_move():
    eng = engine()
    tree = eng.prepare()
    assert eng.prepare() is tree
    eng.pack()
    packed = eng.prepare()
    assert packed is not tree and eng.prepare() is packed
    eng.to(torch.device("cpu"))
    assert eng.prepare() is not packed
    eng.net.dtype = torch.bfloat16
    bf16 = eng.prepare()
    assert bf16["Conv_0"]["kernel"].dtype == torch.bfloat16 and eng.prepare() is bf16


# -- who takes the graph ---------------------------------------------------------------
def _variable_inputs():
    g = torch.Generator().manual_seed(0)
    return (0.1 * torch.randn((2, 1, 12, 32), generator=g),
            torch.randn((2, 1, 12, 32), generator=g),
            0.3 + 0.6 * torch.rand((2, 1, 12, 1), generator=g))


@pytest.mark.parametrize("case", ["grad", "foreign_tree", "switched_off", "train_twin",
                                  "variable", "variable_twin"])
def test_these_forwards_stay_eager(stub, case):
    args = inputs()
    if case.startswith("variable"):
        cls = PackedTrainUNetVariable if case == "variable_twin" else PackedUNetVariable
        torch.manual_seed(0)
        eng = cls(UNetModified2_VariableNoiseLevel(**VAR_NET).eval()).eval()
        args = _variable_inputs()
    else:
        eng = engine(PackedTrainUNetModified2 if case == "train_twin" else PackedUNetModified2)
    if case == "switched_off":  # as chip_smoke.py's plain GroupNorm routes do
        eng.replays_graphs = False
    for _ in range(3):
        with torch.set_grad_enabled(case == "grad"):
            prep = eng.prepare()
            if case == "foreign_tree":
                prep = dict(prep)
            eng(*args, prep=prep)
    assert stub == [] and not eng._graphs


# -- the dispatch around the capture ---------------------------------------------------
@torch.no_grad()
def test_one_capture_a_shape_then_replays_of_the_eager_bits(stub):
    eng = engine()
    calls = [inputs(seed=s) for s in range(5)]
    got = [eng(*c) for c in calls]
    assert len(stub) == 1 and stub[0].replays == 4  # eager, capture + replay, 3 replays
    for c, out in zip(calls, got):
        assert torch.equal(out, eng._forward_eager(*c, eng.prepare()))
    eng(*inputs(rows=3))
    assert len(stub) == 1  # a new shape runs eager first
    eng(*inputs(rows=3))
    assert len(stub) == 2 and len(eng._graphs) == 2


@torch.no_grad()
def test_inputs_are_copied_in_and_the_output_is_a_copy(stub):
    eng = engine()
    eng(*inputs(seed=0))
    first = eng(*inputs(seed=1))
    kept = first.clone()
    graph = next(iter(eng._graphs.values()))
    for static, arg in zip(graph.inputs, inputs(seed=1)):
        assert torch.equal(static, arg)
    second = eng(*inputs(seed=2))
    for static, arg in zip(graph.inputs, inputs(seed=2)):
        assert torch.equal(static, arg)
    assert first.data_ptr() != graph.output.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@torch.no_grad()
def test_the_engine_keeps_at_most_max_graphs(stub):
    eng = engine()
    for rows in range(1, unet_packed.MAX_GRAPHS + 2):
        for _ in range(2):
            eng(*inputs(rows=rows))
    assert len(stub) == unet_packed.MAX_GRAPHS + 1
    assert len(eng._graphs) == unet_packed.MAX_GRAPHS
    assert [k[0][0] for k in eng._graphs] == list(range(2, unet_packed.MAX_GRAPHS + 2))
    eng(*inputs(rows=1))  # dropped: eager again, then captured again
    eng(*inputs(rows=1))
    assert len(stub) == unet_packed.MAX_GRAPHS + 2 and len(eng._graphs) == unet_packed.MAX_GRAPHS
    eng.pack()
    assert not eng._graphs and not eng._seen


@torch.no_grad()
def test_each_replay_counts_the_launches_its_capture_made(stub, counted):
    """The wrapper counts the calls that pass through it, the eager forward's
    and the capture's; a replay passes through none and is counted in the
    engine's ``replays``, beside the graph's own count of its kernels."""
    eng = engine()
    eng(*inputs())
    sites = counted.launches
    assert sites == len(eng.gns) > 0 and (eng.captures, eng.replays) == (0, 0)
    eng(*inputs())  # capture and replay
    assert counted.launches == 2 * sites and (eng.captures, eng.replays) == (1, 1)
    graph = next(iter(eng._graphs.values()))
    assert graph.launches == sites
    for k in range(3):
        eng(*inputs())
        assert counted.launches == 2 * sites and eng.replays == 2 + k
    assert engine().replays == 0 and PackedUNetModified2.replays == 0


@torch.no_grad()
def test_capture_and_replay_spans_only_while_recording(stub):
    eng = engine()
    mark = profiling.mark()
    for _ in range(3):
        eng(*inputs())
    assert [s for s in profiling.spans(mark) if s.name.startswith("denoiser.")] == []
    eng2 = engine()
    with profiling.recording() as spans:
        for _ in range(4):
            eng2(*inputs())
    names = [s.name for s in spans]
    assert names.count("denoiser.capture") == 1 and names.count("denoiser.replay") == 3


def test_infer_through_the_graph_gives_the_eager_loops_bits(stub):
    torch.manual_seed(0)
    net = UNetModified2(**NET).eval()
    model = SDDM(DiffusionSchedule.create("linear", 5, 1e-6, 1e-3),
                 PackedUNetModified2(net).eval(), p_transition="condition_in")
    cond = inputs()[0]
    stream = (torch.randn(cond.shape, generator=torch.Generator().manual_seed(1)),
              [torch.randn(cond.shape, generator=torch.Generator().manual_seed(2 + i))
               for i in range(5)])
    graphed = model.infer(cond, noise_stream=stream)
    assert len(stub) == 1 and stub[0].replays == 4
    eager = PackedUNetModified2(net).eval()
    eager.replays_graphs = False
    model.network = eager
    assert torch.equal(graphed, model.infer(cond, noise_stream=stream))
