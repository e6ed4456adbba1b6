"""Packed (space-to-depth) engines for UNetModified2 (counterparts of
``sddm_tpu/models/unet_packed.py::PackedUNetModified2`` and
``PackedTrainUNetModified2``).

The same function as :class:`UNetModified2`, computed on 2x2
space-to-depth tensors: a level-l activation ``[B, N/2^l, F/2^l, C]``
becomes ``[B, N/2^(l+1), F/2^(l+1), 4C]``, and every convolution runs with a
kernel rearranged once on the host (``ops/packed.py``).  Inside a packed
res block the two 3x3 convolutions hop to the offset-packed grid and back
with 2x2 kernels (9/16 nonzero, against 1/4 for the dense 3x3 packed
kernel), the JAX package's default.  The statistics barrier and the
tap-stacked head of the JAX engine are off there by default and are not
ported.

Activations are NHWC tensors, as in the JAX engine; a convolution sees the
free ``permute(0, 3, 1, 2)`` view, a channels-last NCHW tensor, with
channels-last OIHW weights, so cuDNN runs it in NHWC.  Every GroupNorm ->
SiLU (-> offset mask) site calls :func:`gn_silu_nhwc`, the CUDA kernel on
the card.

Both engines pack through one traversal, :meth:`PackedUNetModified2._pack_with`,
parameterised by a kit of operations: the inference engine packs once on the
host (:class:`_HostKit`, numpy); the training twin packs the live parameters
of its plain network on every forward (:class:`_BlockKit`, the default, or
:class:`_TracedKit`, ``SDDM_PACK_IMPL``), so that autograd carries the
packed gradients back to the plain parameters, and its GroupNorm sites run
:class:`GroupNormSiLUNhwcFunction`, whose backward is
:func:`gn_silu_nhwc_backward`, the backward kernel on the card.

On a card with autograd off, the inference engine's forward replays a CUDA
graph of its body (:meth:`PackedUNetModified2.forward`), captured once per
input shape: one graph launch in place of about 250 kernel launches, the
same kernels and bits.
"""

from __future__ import annotations

import collections
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import packed as pk
from ..ops.framing import frame_signal, overlap_add
from ..ops.gn_silu import (
    GroupNormSiLUNhwcFunction,
    gn_silu_nhwc,
    gn_silu_nhwc_backward,
    group_order,
)
from ..utils.profiling import span
from .blocks import Downsample, ResnetBlock
from .unet_modified2 import UNetModified2

MAX_GRAPHS = 4  # captured forwards an engine keeps, the least recently replayed dropped first


def _packed_gn_plan(groups: int, sections: Tuple[int, ...]):
    """GroupNorm plan over a packed (possibly concatenated) tensor:
    (ch_orig, group_of, count): each packed channel's original channel, its
    group, and the packed channels per group at one position."""
    total = sum(sections)
    k = total // groups
    ch_orig = []  # channel order of concat(packed(s) for s in sections)
    off = 0
    for c in sections:
        for _phase in range(4):
            ch_orig.extend(range(off, off + c))
        off += c
    ch_orig = np.asarray(ch_orig)
    return ch_orig, ch_orig // k, 4 * k


class _GN(nn.Module):
    """GroupNorm -> SiLU (-> offset mask) of one call site, on NHWC input:
    :func:`gn_silu_nhwc` with the site's channel -> group map.  ``scale`` and
    ``bias`` are in the site's channel order; an unpacked site has the
    identity map (group ``c // (C / G)``).  ``order``, the group-major
    channel list of the kernel, is built once here (not saved)."""

    def __init__(self, scale, bias, group_of, groups: int, count: int, offset: bool = False):
        super().__init__()
        self.groups, self.count, self.offset, self.eps = groups, int(count), bool(offset), 1e-5
        self.register_buffer("scale", torch.as_tensor(np.asarray(scale, np.float32)))
        self.register_buffer("bias", torch.as_tensor(np.asarray(bias, np.float32)))
        self.register_buffer("group_of", torch.as_tensor(np.asarray(group_of, np.int32)))
        self.register_buffer("order", group_order(self.group_of, groups), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gn_silu_nhwc(x, self.scale, self.bias, self.group_of, self.groups,
                            self.count, self.offset, self.eps, order=self.order)


class _TrainGN:
    """A GroupNorm -> SiLU (-> offset mask) site of the training twin: its
    ``scale`` and ``bias`` are packed from the live parameters, so autograd
    carries their gradients back.  Where autograd records it runs
    :class:`GroupNormSiLUNhwcFunction` (forward :func:`gn_silu_nhwc`,
    backward :func:`gn_silu_nhwc_backward`, both looked up here at call
    time), else :func:`gn_silu_nhwc` alone."""

    def __init__(self, scale, bias, group_of, order, groups: int, count: int, offset: bool):
        self.scale, self.bias, self.group_of, self.order = scale, bias, group_of, order
        self.groups, self.count, self.offset, self.eps = groups, int(count), bool(offset), 1e-5

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or self.scale.requires_grad
                                        or self.bias.requires_grad):
            return GroupNormSiLUNhwcFunction.apply(
                x, self.scale, self.bias, self.group_of, self.groups, self.count, self.offset,
                self.eps, self.order, gn_silu_nhwc, gn_silu_nhwc_backward)
        return gn_silu_nhwc(x, self.scale, self.bias, self.group_of, self.groups, self.count,
                            self.offset, self.eps, order=self.order)


# -- the flax-named weight tree of the port's plain network ---------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _conv_np(m) -> dict:
    return {"kernel": _np(m.weight).transpose(2, 3, 1, 0), "bias": _np(m.bias)}  # HWIO


def _dense_np(m) -> dict:
    return {"kernel": _np(m.weight).T, "bias": _np(m.bias)}  # [I, O]


def _conv_live(m) -> dict:
    return {"kernel": m.weight.permute(2, 3, 1, 0), "bias": m.bias}  # HWIO views


def _dense_live(m) -> dict:
    return {"kernel": m.weight.t(), "bias": m.bias}


def _block_tree(blk, live: bool) -> dict:
    """A ``Block``'s GroupNorm and conv in the JAX package's names."""
    conv = _conv_live if live else _conv_np
    vec = (lambda t: t) if live else _np
    gn = blk.block[0]
    return {"GroupNorm_0": {"scale": vec(gn.weight), "bias": vec(gn.bias)},
            "Conv_0": conv(blk.block[3])}


def _flax_tree(net: UNetModified2, live: bool = False) -> dict:
    """The JAX package's parameter tree of ``net`` (HWIO kernels), in its
    module names: the inverse of ``compat/jax_import.py``'s bridge.  numpy
    copies, or with ``live`` views of the parameters themselves, which
    autograd follows."""
    conv, dense = (_conv_live, _dense_live) if live else (_conv_np, _dense_np)

    p = {"NoiseLevelMLP_0": {"Dense_0": dense(net.noise_level_mlp[1]),
                             "Dense_1": dense(net.noise_level_mlp[3])},
         "Conv_0": conv(net.downs[0])}
    rb = ds = us = 0
    for layer in list(net.downs[1:]) + list(net.mid) + list(net.ups):
        if isinstance(layer, ResnetBlock):
            e = {"Block_0": _block_tree(layer.block1, live),
                 "Block_1": _block_tree(layer.block2, live),
                 "FeatureWiseAffine_0": {"Dense_0": dense(layer.noise_func.noise_func[0])}}
            if isinstance(layer.res_conv, nn.Conv2d):
                e["Conv_0"] = conv(layer.res_conv)
            p[f"ResnetBlock_{rb}"] = e
            rb += 1
        elif isinstance(layer, Downsample):
            p[f"Downsample_{ds}"] = {"Conv_0": conv(layer.conv)}
            ds += 1
        else:
            p[f"Upsample_{us}"] = {"Conv_0": conv(layer.conv)}
            us += 1
    p["Block_0"] = _block_tree(net.final_conv, live)
    return p


def _unperm(w: np.ndarray, perm: np.ndarray) -> np.ndarray:
    wcat = np.empty_like(w)
    wcat[:, :, perm, :] = w
    return wcat


class _HostKit:
    """numpy operations for the one-time host packing (inference engine)."""

    s1 = staticmethod(pk.pack_kernel_s1)
    s1to = staticmethod(pk.pack_kernel_s1_to_offset)
    s1from = staticmethod(pk.pack_kernel_s1_from_offset)
    s2u = staticmethod(pk.pack_kernel_s2_unpacked_out)
    s2p = staticmethod(pk.pack_kernel_s2_packed_out)
    up = staticmethod(pk.pack_kernel_upsample)
    unperm = staticmethod(_unperm)

    @staticmethod
    def tile4(b):
        return np.tile(b, 4)

    @staticmethod
    def take(x, idx):
        return x[idx]


class _TracedKit:
    """torch operations for the differentiable packing of the training twin:
    the kernel transforms as flat-index gathers (``pack_kernel_traced``).  On
    a card the gathers' backward adds with atomics, in no fixed order:
    ``SDDM_PACK_IMPL=gather`` is the JAX package's alternative, tested on the
    CPU."""

    s1 = staticmethod(lambda w: pk.pack_kernel_traced("s1", w))
    s1to = staticmethod(lambda w: pk.pack_kernel_traced("s1to", w))
    s1from = staticmethod(lambda w: pk.pack_kernel_traced("s1from", w))
    s2u = staticmethod(lambda w: pk.pack_kernel_traced("s2u", w))
    s2p = staticmethod(lambda w: pk.pack_kernel_traced("s2p", w))
    up = staticmethod(lambda w: pk.pack_kernel_traced("up", w))

    @staticmethod
    def tile4(b):
        return b.repeat(4)  # its backward sums the four copies in a fixed order

    @staticmethod
    def take(x, idx):
        return x[torch.as_tensor(np.asarray(idx), device=x.device)]

    @staticmethod
    def unperm(w, perm):
        return w[:, :, torch.as_tensor(np.argsort(perm), device=w.device)]


class _BlockKit(_TracedKit):
    """Gather-free differentiable packing, the default (the JAX package's
    ``SDDM_PACK_IMPL=blocks``): kernel transforms from slices and one
    concatenation (``pack_kernel_blocks``), vector and channel reorders as
    exact one-hot products, so that every gradient sums in a fixed order."""

    s1 = staticmethod(lambda w: pk.pack_kernel_blocks("s1", w))
    s1to = staticmethod(lambda w: pk.pack_kernel_blocks("s1to", w))
    s1from = staticmethod(lambda w: pk.pack_kernel_blocks("s1from", w))
    s2u = staticmethod(lambda w: pk.pack_kernel_blocks("s2u", w))
    s2p = staticmethod(lambda w: pk.pack_kernel_blocks("s2p", w))
    up = staticmethod(lambda w: pk.pack_kernel_blocks("up", w))
    take = staticmethod(pk.onehot_take)
    unperm = staticmethod(pk.onehot_unperm_axis2)


def select_traced_kit():
    """The kit ``SDDM_PACK_IMPL`` selects for the training twin's packing:
    ``blocks`` (the default) or ``gather``."""
    impl = os.environ.get("SDDM_PACK_IMPL", "blocks")
    if impl not in ("gather", "blocks"):
        raise ValueError(f"SDDM_PACK_IMPL must be gather|blocks: {impl}")
    return _BlockKit if impl == "blocks" else _TracedKit


def _torch_tree(node):
    """numpy tree -> torch: 4-D conv kernels HWIO -> channels-last OIHW."""
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        if node.ndim == 4:
            return torch.from_numpy(np.ascontiguousarray(node.transpose(3, 2, 0, 1))) \
                .contiguous(memory_format=torch.channels_last)
        return torch.from_numpy(np.ascontiguousarray(node))
    return node


def _conv(x: torch.Tensor, p: dict, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC convolution through the channels-last NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"], p["bias"], stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a card, outside any stream capture."""
    return t.is_cuda and not torch.cuda.is_current_stream_capturing()


def _cuda_graph(body):
    """Capture ``body()`` into a ``torch.cuda.CUDAGraph`` on its own memory
    pool: ``(graph, body's output)``.  Only this thread's calls are checked
    against the capture (another thread's work on the card goes on)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = body()
    return graph, out


class _Graph:
    """One captured forward: the static inputs it reads, the graph, the
    static output it writes, and the :func:`gn_silu_nhwc` calls its capture
    made (``launches``: the kernels each replay launches).  A call copies its
    inputs into the static ones, replays and returns a copy of the output,
    which the next replay overwrites.  A replay passes through no wrapper,
    so ``gn_silu_nhwc.launches`` counts only the capture's calls."""

    def __init__(self, body, args):
        self.inputs = tuple(a.clone(memory_format=torch.contiguous_format) for a in args)
        before = gn_silu_nhwc.launches
        try:
            self.graph, self.output = _cuda_graph(lambda: body(*self.inputs))
        except Exception as e:
            shapes = ", ".join(f"{tuple(a.shape)} {a.dtype}" for a in args)
            raise RuntimeError(
                f"capturing the packed denoiser's forward in a CUDA graph failed for inputs "
                f"{shapes} on {args[0].device}: {e}. The forward's body may hold no host "
                f"synchronisation (a copy from host memory, .item()) and no launch that stream "
                f"capture refuses") from e
        self.launches = gn_silu_nhwc.launches - before

    def __call__(self, *args) -> torch.Tensor:
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        return self.output.clone()


class PackedUNetModified2(nn.Module):
    """Drop-in inference twin of a :class:`UNetModified2`, packed from its
    weights at construction (and again by :meth:`pack`).

    ``packed_levels``: how many of the shallowest encoder/decoder levels run
    in the packed representation (0 = the plain network's function on NHWC
    tensors, ``len(channel_mults)`` = everything packed, the default).  The
    plain network stays a submodule, ``self.net``: its parameters give the
    engine's device, and its ``dtype`` is the engine's compute dtype.

    On a card with autograd off, given :meth:`prepare`'s own tree, the
    forward replays a CUDA graph of :meth:`_forward_eager` (see
    :meth:`forward`); ``replays_graphs`` is False on the training twins,
    whose packed tree changes every step.  ``captures`` and ``replays``
    count the graphs captured and the forwards replayed from one."""

    replays_graphs = True
    captures = replays = 0

    def __init__(self, net: UNetModified2, packed_levels: int | None = None):
        super().__init__()
        if net.dropout:
            raise ValueError("packed engine is inference-only (dropout=0)")
        self.net = net
        self.num_levels = len(net.channel_mults)
        self.packed_levels = self.num_levels if packed_levels is None else packed_levels
        self._new_caches()
        self.pack()

    def _new_caches(self) -> None:
        """What the engine makes once from its installed tensors and keeps:
        the offset masks by shape, the noise encoding's frequencies and
        :meth:`prepare`'s tree by compute dtype, the captured forwards by
        input shape (least recently replayed first) and the shapes seen once."""
        self._masks: Dict[tuple, torch.Tensor] = {}
        self._encodings: Dict[tuple, torch.Tensor] = {}
        self._prepared: Dict[torch.dtype, Dict] = {}
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: set = set()

    def _drop_caches(self) -> None:
        """Forget what was made from the installed tensors, once the card has
        run every replay that reads them."""
        if self._graphs and torch.cuda.is_available():
            torch.cuda.synchronize()
        for cache in (self._masks, self._encodings, self._prepared, self._graphs, self._seen):
            cache.clear()

    def _apply(self, *args, **kwargs):
        # .to(), .cuda(), .half() replace the buffers that the caches hold
        out = super()._apply(*args, **kwargs)
        self._drop_caches()
        return out

    # -- parameter packing ----------------------------------------------------
    def pack(self) -> Dict:
        """Re-express the plain network's weights for the packed engine (one
        host-side pass, the packing functions of ``ops/packed.py``) and install them.
        Returns the packed tree in the JAX engine's names: conv kernels as
        channels-last OIHW tensors, dense kernels ``[I, O]``, and per
        GroupNorm site ``scale``, ``bias``, ``group_of``, ``count`` and
        ``offset``."""
        tree = _torch_tree(self._pack_with(_HostKit, self._tree()))
        self._install(tree, next(self.net.parameters()).device)
        return tree

    def _tree(self, live: bool = False) -> Dict:
        """The plain network's flax-named tree (:func:`_flax_tree`)."""
        return _flax_tree(self.net, live)

    # the flax names of a res block and of its residual conv
    _RB, _RES = "ResnetBlock", "Conv_0"

    def _copied(self, p: Dict) -> Dict:
        """The entries of ``p`` that the packing copies through: the noise
        MLP."""
        return {"NoiseLevelMLP_0": p["NoiseLevelMLP_0"]}

    def _rb_noise(self, src: Dict) -> Dict:
        """A res block's noise injection, copied through: its dense layer."""
        return {"fwa": dict(src["FeatureWiseAffine_0"]["Dense_0"])}

    def _pack_with(self, kit, p: Dict) -> Dict:
        """The packed tree of the flax-named tree ``p`` (HWIO kernels), every
        operation from ``kit``: conv and dense weights as the kit's arrays, and
        per GroupNorm site a dict of ``scale`` and ``bias`` (the kit's arrays,
        in the site's channel order), ``group_of`` (numpy int32), ``count``
        and ``offset``.  The traversal is shared with the variable network's
        engine, which names its res blocks and residual convs otherwise
        (``_RB``, ``_RES``) and copies other entries through (``_copied``,
        ``_rb_noise``)."""
        net = self.net
        ic, groups = net.inner_channel, net.norm_groups
        packed: Dict[str, Any] = self._copied(p)
        lp = lambda level: level < self.packed_levels  # noqa: E731

        def s1_cat(w, sections):
            wp = kit.s1(w)
            if len(sections) > 1:
                wp = kit.unperm(wp, pk.pack_input_map(sections))
            return wp

        def make_gn(gnsrc, sections, is_packed, offset=False):
            sc, bi = gnsrc["scale"], gnsrc["bias"]
            if is_packed:
                ch_orig, group_of, count = _packed_gn_plan(groups, sections)
                sc, bi = kit.take(sc, ch_orig), kit.take(bi, ch_orig)
            else:
                count = sc.shape[0] // groups
                group_of = np.arange(sc.shape[0]) // count
            return {"scale": sc, "bias": bi, "group_of": group_of.astype(np.int32),
                    "count": count, "offset": offset}

        def conv1(src, kind, packed_in, packed_out):
            w, b = src["kernel"], src["bias"]
            if kind == "s1":
                if packed_in:
                    w, b = kit.s1(w), kit.tile4(b)
            elif kind == "down":
                if packed_in and packed_out:
                    w, b = kit.s2p(w), kit.tile4(b)
                elif packed_in:
                    w = kit.s2u(w)
                elif packed_out:
                    raise NotImplementedError("unpacked->packed downsample")
            elif kind == "up":
                if packed_out:
                    w, b = kit.up(w), kit.tile4(b)
            return {"kernel": w, "bias": b}

        def rb(src, sections, is_packed, cout):
            e: Dict[str, Any] = {}
            cin = sum(sections)
            offset = is_packed  # offset-grid res-block convs, the JAX default
            # Block_0 (input may be a packed concat); in offset mode its conv
            # hops to the offset-packed grid and Block_1's conv hops back
            w, b = src["Block_0"]["Conv_0"]["kernel"], src["Block_0"]["Conv_0"]["bias"]
            if offset:
                w = kit.s1to(w)
                if len(sections) > 1:
                    w = kit.unperm(w, pk.pack_input_map(sections))
                b = kit.tile4(b)
            e["Block_0"] = {"gn": make_gn(src["Block_0"]["GroupNorm_0"], sections, is_packed),
                            "conv": {"kernel": w, "bias": b}}
            w, b = src["Block_1"]["Conv_0"]["kernel"], src["Block_1"]["Conv_0"]["bias"]
            if offset:
                w, b = kit.s1from(w), kit.tile4(b)
            e["Block_1"] = {"gn": make_gn(src["Block_1"]["GroupNorm_0"], (cout,), is_packed,
                                          offset=offset),
                            "conv": {"kernel": w, "bias": b}}
            e.update(self._rb_noise(src))
            if cin != cout:
                w, b = src[self._RES]["kernel"], src[self._RES]["bias"]
                if is_packed:
                    w, b = s1_cat(w, sections), kit.tile4(b)
                e["res"] = {"kernel": w, "bias": b}
            return e

        def rb_at(i, sections, is_packed, cout):
            name = f"{self._RB}_{i}"
            packed[name] = rb(p[name], sections, is_packed, cout)

        rb_i = ds_i = us_i = 0
        packed["Conv_0"] = conv1(p["Conv_0"], "s1", lp(0), lp(0))
        skips: List[int] = [ic]
        n_in = ic
        for lvl, mult in enumerate(net.channel_mults):
            n_out = ic * mult
            for _ in range(net.res_blocks):
                rb_at(rb_i, (n_in,), lp(lvl), n_out)
                skips.append(n_out)
                n_in = n_out
                rb_i += 1
            packed[f"Downsample_{ds_i}"] = conv1(p[f"Downsample_{ds_i}"]["Conv_0"], "down",
                                                 lp(lvl), lp(lvl + 1))
            skips.append(n_out)
            ds_i += 1

        rb_at(rb_i, (n_in,), lp(self.num_levels), n_in)
        rb_i += 1

        h_c = n_in
        for ind in reversed(range(self.num_levels)):
            n_ch = ic * net.channel_mults[ind]
            rb_at(rb_i, (h_c, skips.pop()), lp(ind + 1), n_ch)
            h_c = n_ch
            rb_i += 1
            packed[f"Upsample_{us_i}"] = conv1(p[f"Upsample_{us_i}"]["Conv_0"], "up",
                                               lp(ind + 1), lp(ind))
            us_i += 1
            n_out = ic if ind == 0 else ic * net.channel_mults[ind - 1]
            for _ in range(net.res_blocks):
                rb_at(rb_i, (h_c, skips.pop()), lp(ind), n_out)
                h_c = n_out
                rb_i += 1

        w, b = p["Block_0"]["Conv_0"]["kernel"], p["Block_0"]["Conv_0"]["bias"]
        gn = make_gn(p["Block_0"]["GroupNorm_0"], (h_c,), lp(0))
        if lp(0):
            w, b = kit.s1(w), kit.tile4(b)
        packed["Block_0"] = {"gn": gn, "conv": {"kernel": w, "bias": b}}
        return packed

    def _install(self, tree: Dict, device: torch.device) -> None:
        """Keep the packed tensors as (non-persistent) buffers, so that
        ``.to()`` moves them, and each GroupNorm site as a :class:`_GN` in
        ``self.gns``; ``self._layout`` is the tree with names at its leaves."""
        gns: Dict[str, _GN] = {}

        def walk(node, path):
            if "gn" == path[-1]:
                key = "__".join(path[:-1])
                gns[key] = _GN(node["scale"], node["bias"], node["group_of"],
                               self.net.norm_groups, node["count"], node["offset"])
                return ("gn", key)
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            name = "__".join(path)
            self.register_buffer(name, node.to(device), persistent=False)
            return ("buffer", name)

        self._layout = {k: walk(v, (k,)) for k, v in tree.items()}
        self.gns = nn.ModuleDict(gns).to(device)
        self._drop_caches()

    def prepare(self) -> Dict:
        """The packed tree for ``SDDM.infer`` and :meth:`forward`: conv and
        dense weights cast to the compute dtype, GroupNorm sites as their
        :class:`_GN` modules (f32 affine).  Made once per compute dtype after
        :meth:`pack` (or a move of the engine) and then returned as it is, so
        that a captured forward reads weights at fixed addresses."""
        dt = self.net.dtype
        if dt not in self._prepared:
            def build(node):
                if isinstance(node, dict):
                    return {k: build(v) for k, v in node.items()}
                kind, name = node
                return self.gns[name] if kind == "gn" else getattr(self, name).to(dt)

            self._prepared[dt] = build(self._layout)
        return self._prepared[dt]

    def _offset_mask(self, y: torch.Tensor) -> torch.Tensor:
        key = (tuple(y.shape[1:]), y.dtype, y.device)
        if key not in self._masks:
            h, w, c4 = y.shape[1:]
            self._masks[key] = torch.from_numpy(pk.offset_mask(h, w, c4 // 4)).to(y.device,
                                                                                 y.dtype)
        return self._masks[key]

    def _encoding(self, dt: torch.dtype, device: torch.device) -> torch.Tensor:
        """The noise level encoding's frequencies ``1e4 * 10^(-4 i / half)``
        in ``dt`` on ``device``, made once: a copy from the host in every
        forward would wait for the stream, and stream capture refuses it."""
        key = (dt, device)
        if key not in self._encodings:
            half = self.net.inner_channel // 2
            step = np.arange(half, dtype=np.float32)
            self._encodings[key] = torch.as_tensor(1e4 * 10.0 ** (-step * 4.0 / half),
                                                   dtype=dt, device=device)
        return self._encodings[key]

    # -- forward ----------------------------------------------------------------
    def forward(self, condition: torch.Tensor, x_t: torch.Tensor, noise_level: torch.Tensor,
                prep: Dict | None = None) -> torch.Tensor:
        """condition, x_t: ``[B, 1, T]``; noise_level: any shape flattening to
        ``[B]``; ``prep``: :meth:`prepare`'s tree (taken here when not given).
        Returns the predicted noise ``[B, 1, T]``.

        Where :meth:`_replays` holds, the body (:meth:`_forward_eager`) runs
        from a CUDA graph: the first forward at an input shape runs eager
        (nvcc's builds, cuDNN's choices, the masks), the second captures the
        body on static inputs, and every later one replays it
        (:class:`_Graph`).  The engine keeps ``MAX_GRAPHS`` graphs.  Any
        other call runs the body eager.  Spans (``utils/profiling``, while
        recording): ``denoiser.capture`` and ``denoiser.replay``."""
        pp = self.prepare() if prep is None else prep
        if not self._replays(x_t, pp):
            return self._forward_eager(condition, x_t, noise_level, pp)
        key = (tuple(condition.shape), condition.dtype, tuple(x_t.shape), x_t.dtype,
               tuple(noise_level.shape), noise_level.dtype, x_t.device, self.net.dtype,
               torch.is_inference_mode_enabled())
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._seen:
                self._seen.add(key)
                return self._forward_eager(condition, x_t, noise_level, pp)
            with span("denoiser.capture"):
                graph = _Graph(lambda *a: self._forward_eager(*a, pp),
                               (condition, x_t, noise_level))
            self.captures += 1
            self._seen.discard(key)
            self._graphs[key] = graph
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        self.replays += 1
        with span("denoiser.replay"):
            return graph(condition, x_t, noise_level)

    def _replays(self, x_t: torch.Tensor, pp: Dict) -> bool:
        """Whether a forward runs from a CUDA graph: an engine that replays
        graphs (``replays_graphs``), a card's tensor outside any capture,
        autograd off and the tree :meth:`prepare` keeps."""
        return (self.replays_graphs and _on_card(x_t) and not torch.is_grad_enabled()
                and pp is self._prepared.get(self.net.dtype))

    def _forward_eager(self, condition: torch.Tensor, x_t: torch.Tensor,
                       noise_level: torch.Tensor, pp: Dict) -> torch.Tensor:
        """The forward's body, each operation launched from here."""
        net = self.net
        in_dtype, dt = x_t.dtype, net.dtype
        lp = lambda level: level < self.packed_levels  # noqa: E731

        cond_f = frame_signal(condition[:, 0], net.segment_len, net.segment_stride)
        xt_f = frame_signal(x_t[:, 0], net.segment_len, net.segment_stride)
        h = torch.stack([cond_f, xt_f], dim=-1).to(dt)  # NHWC [B, N, F, 2]
        h = pk.s2d(h) if lp(0) else h.contiguous()

        # noise MLP: PositionalEncoding, Dense, silu, Dense, silu
        nl = noise_level.to(dt)
        enc = nl.reshape(-1, 1) * self._encoding(dt, nl.device)[None, :]
        t = torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)
        mlp = pp["NoiseLevelMLP_0"]
        t = F.silu(t @ mlp["Dense_0"]["kernel"] + mlp["Dense_0"]["bias"])
        t_emb = F.silu(t @ mlp["Dense_1"]["kernel"] + mlp["Dense_1"]["bias"])

        def run_rb(e, x):
            # offset mode (2x2 Block_0 kernel): Block_0's conv produces the
            # offset-packed grid, one extra block per axis, and Block_1's
            # VALID conv consumes it back to the standard grid
            offset = e["Block_0"]["conv"]["kernel"].shape[-1] == 2
            y = _conv(e["Block_0"]["gn"](x), e["Block_0"]["conv"], padding=1)
            fwa = t_emb @ e["fwa"]["kernel"] + e["fwa"]["bias"]
            if e["Block_1"]["conv"]["kernel"].shape[1] == 4 * fwa.shape[1]:
                fwa = fwa.repeat(1, 4)  # packed: the bias tiled over the 4 phases
            y = y + fwa[:, None, None, :]
            blk = e["Block_1"]
            if offset:
                # zero the out-of-range plain rows/cols so the statistics see
                # zeros there; the kernel zeroes them again after the SiLU,
                # where the VALID conv reads the plain conv's SAME padding
                y2 = _conv(blk["gn"](y * self._offset_mask(y)), blk["conv"])
            else:
                y2 = _conv(blk["gn"](y), blk["conv"], padding=1)
            if "res" in e:
                x = _conv(x, e["res"])
            return y2 + x

        rb_i = ds_i = us_i = 0
        h = _conv(h, pp["Conv_0"], padding=1)
        feats = [h]
        for lvl, _mult in enumerate(net.channel_mults):
            for _ in range(net.res_blocks):
                h = run_rb(pp[f"ResnetBlock_{rb_i}"], h)
                feats.append(h)
                rb_i += 1
            e = pp[f"Downsample_{ds_i}"]
            if lp(lvl) and not lp(lvl + 1):  # packed -> unpacked half grid
                h = _conv(F.pad(h, (0, 0, 1, 0, 1, 0)), e)
            else:
                h = _conv(h, e, stride=2, padding=1)
            feats.append(h)
            ds_i += 1

        h = run_rb(pp[f"ResnetBlock_{rb_i}"], h)
        rb_i += 1

        for ind in reversed(range(self.num_levels)):
            h = run_rb(pp[f"ResnetBlock_{rb_i}"], torch.cat([h, feats.pop()], dim=-1))
            rb_i += 1
            e = pp[f"Upsample_{us_i}"]
            if lp(ind) and lp(ind + 1):
                h = pk.d2s(h)
            elif not lp(ind):  # nearest 2x upsample
                b_, hh, ww, cc = h.shape
                h = h[:, :, None, :, None, :].expand(b_, hh, 2, ww, 2, cc).reshape(
                    b_, 2 * hh, 2 * ww, cc)
            h = _conv(h, e, padding=1)
            us_i += 1
            for _ in range(net.res_blocks):
                h = run_rb(pp[f"ResnetBlock_{rb_i}"], torch.cat([h, feats.pop()], dim=-1))
                rb_i += 1

        e = pp["Block_0"]
        out = _conv(e["gn"](h), e["conv"], padding=1)
        if lp(0):
            out = pk.d2s(out)
        out = out.permute(0, 3, 1, 2).to(in_dtype)  # [B, 1, N, F]
        return overlap_add(out, net.num_samples, net.segment_stride)


class PackedTrainUNetModified2(PackedUNetModified2):
    """Training twin: the packed forward differentiated with respect to the
    plain :class:`UNetModified2`'s parameters, its only parameters (as
    ``self.net``), so checkpoints keep the plain layout.

    :meth:`prepare` packs the live parameters with the kit
    ``SDDM_PACK_IMPL`` selects (:func:`select_traced_kit`, ``blocks`` by
    default): on every ``SDDM.forward``, through :meth:`forward`, and once
    per ``SDDM.infer``.  Its GroupNorm sites run
    :class:`GroupNormSiLUNhwcFunction`, the NHWC kernels of both directions
    on the card.  Dropout must be 0, as in the JAX package: the packed layout
    interleaves channels, so per-channel dropout masks would not
    correspond.  Its forward runs eager: the packed tree is new each time."""

    replays_graphs = False

    def __init__(self, net: UNetModified2, packed_levels: int | None = None):
        nn.Module.__init__(self)
        if net.dropout:
            raise ValueError("the packed training engine requires dropout=0, got "
                             f"dropout={net.dropout}")
        self.net = net
        self.num_levels = len(net.channel_mults)
        self.packed_levels = self.num_levels if packed_levels is None else packed_levels
        self._new_caches()
        self._maps: Dict[tuple, tuple] = {}

    def pack_traced(self) -> Dict:
        """The packed tree of the live parameters (HWIO kernels, float32),
        connected to them by autograd: :meth:`_pack_with` with the selected
        traced kit."""
        return self._pack_with(select_traced_kit(), self._tree(live=True))

    def prepare(self) -> Dict:
        """The packed tree for one forward or one ``SDDM.infer``, as
        :meth:`PackedUNetModified2.prepare` gives it: conv kernels as
        channels-last OIHW and dense weights in the compute dtype, GroupNorm
        sites as :class:`_TrainGN` (f32 affine)."""
        dt = self.net.dtype

        def build(node):
            if isinstance(node, dict) and "group_of" in node:
                group_of, order = self._site_maps(node["group_of"], node["scale"].device)
                return _TrainGN(node["scale"], node["bias"], group_of, order,
                                self.net.norm_groups, node["count"], node["offset"])
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if node.dim() == 4:  # HWIO -> OIHW, channels last
                return node.permute(3, 2, 0, 1).to(dtype=dt, memory_format=torch.channels_last)
            return node.to(dt)

        return build(self.pack_traced())

    def _site_maps(self, group_of: np.ndarray, device) -> tuple:
        """A site's channel -> group map and group-major channel list on
        ``device``, made once (a copy from the host on every step would wait
        for the stream)."""
        key = (group_of.tobytes(), str(device))
        if key not in self._maps:
            g = torch.from_numpy(group_of).to(device)
            self._maps[key] = (g, group_order(g, self.net.norm_groups))
        return self._maps[key]


def plain_network(network: nn.Module) -> nn.Module:
    """The module whose parameters are trained and checkpointed: the plain
    network of a :class:`PackedTrainUNetModified2` (the variable network's
    twin, ``unet_variable_packed.PackedTrainUNetVariable``, is one too), else
    ``network``."""
    return network.net if isinstance(network, PackedTrainUNetModified2) else network
