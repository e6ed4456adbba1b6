"""Packed (space-to-depth) inference engine for UNetModified2 (counterpart of
``sddm_tpu/models/unet_packed.py::PackedUNetModified2``).

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
SiLU (-> offset mask) site is a :class:`_GN` module that calls
:func:`gn_silu_nhwc`, the CUDA kernel on the card.  Inference only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import packed as pk
from ..ops.framing import frame_signal, overlap_add
from ..ops.gn_silu import gn_silu_nhwc, group_order
from .blocks import Downsample, ResnetBlock
from .unet_modified2 import UNetModified2


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


# -- the flax-named weight tree of the port's plain network ---------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _conv_np(m) -> dict:
    return {"kernel": _np(m.weight).transpose(2, 3, 1, 0), "bias": _np(m.bias)}  # HWIO


def _dense_np(m) -> dict:
    return {"kernel": _np(m.weight).T, "bias": _np(m.bias)}  # [I, O]


def _block_np(blk) -> dict:
    gn = blk.block[0]
    return {"GroupNorm_0": {"scale": _np(gn.weight), "bias": _np(gn.bias)},
            "Conv_0": _conv_np(blk.block[3])}


def _rb_np(rb: ResnetBlock) -> dict:
    out = {"Block_0": _block_np(rb.block1), "Block_1": _block_np(rb.block2),
           "FeatureWiseAffine_0": {"Dense_0": _dense_np(rb.noise_func.noise_func[0])}}
    if isinstance(rb.res_conv, nn.Conv2d):
        out["Conv_0"] = _conv_np(rb.res_conv)
    return out


def _flax_tree(net: UNetModified2) -> dict:
    """The JAX package's parameter tree of ``net`` (numpy, HWIO kernels), in
    its module names: the inverse of ``compat/jax_import.py``'s bridge."""
    p = {"NoiseLevelMLP_0": {"Dense_0": _dense_np(net.noise_level_mlp[1]),
                             "Dense_1": _dense_np(net.noise_level_mlp[3])},
         "Conv_0": _conv_np(net.downs[0])}
    rb = ds = us = 0
    for layer in list(net.downs[1:]) + list(net.mid) + list(net.ups):
        if isinstance(layer, ResnetBlock):
            p[f"ResnetBlock_{rb}"] = _rb_np(layer)
            rb += 1
        elif isinstance(layer, Downsample):
            p[f"Downsample_{ds}"] = {"Conv_0": _conv_np(layer.conv)}
            ds += 1
        else:
            p[f"Upsample_{us}"] = {"Conv_0": _conv_np(layer.conv)}
            us += 1
    p["Block_0"] = _block_np(net.final_conv)
    return p


def _unperm(w: np.ndarray, perm: np.ndarray) -> np.ndarray:
    wcat = np.empty_like(w)
    wcat[:, :, perm, :] = w
    return wcat


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


class PackedUNetModified2(nn.Module):
    """Drop-in inference twin of a :class:`UNetModified2`, packed from its
    weights at construction (and again by :meth:`pack`).

    ``packed_levels``: how many of the shallowest encoder/decoder levels run
    in the packed representation (0 = the plain network's function on NHWC
    tensors, ``len(channel_mults)`` = everything packed, the default).  The
    plain network stays a submodule, ``self.net``: its parameters give the
    engine's device, and its ``dtype`` is the engine's compute dtype."""

    def __init__(self, net: UNetModified2, packed_levels: int | None = None):
        super().__init__()
        if net.dropout:
            raise ValueError("packed engine is inference-only (dropout=0)")
        self.net = net
        self.num_levels = len(net.channel_mults)
        self.packed_levels = self.num_levels if packed_levels is None else packed_levels
        self._masks: Dict[tuple, torch.Tensor] = {}
        self.pack()

    # -- parameter packing ----------------------------------------------------
    def pack(self) -> Dict:
        """Re-express the plain network's weights for the packed engine (one
        host-side pass, the packing functions of ``ops/packed.py``) and install them.
        Returns the packed tree in the JAX engine's names: conv kernels as
        channels-last OIHW tensors, dense kernels ``[I, O]``, and per
        GroupNorm site ``scale``, ``bias``, ``group_of``, ``count`` and
        ``offset``."""
        net = self.net
        p = _flax_tree(net)
        ic, groups = net.inner_channel, net.norm_groups
        packed: Dict[str, Any] = {"NoiseLevelMLP_0": p["NoiseLevelMLP_0"]}
        lp = lambda level: level < self.packed_levels  # noqa: E731

        def s1_cat(w, sections):
            wp = pk.pack_kernel_s1(w)
            if len(sections) > 1:
                wp = _unperm(wp, pk.pack_input_map(sections))
            return wp

        def make_gn(gnsrc, sections, is_packed, offset=False):
            sc, bi = gnsrc["scale"], gnsrc["bias"]
            if is_packed:
                ch_orig, group_of, count = _packed_gn_plan(groups, sections)
                sc, bi = sc[ch_orig], bi[ch_orig]
            else:
                count = sc.shape[0] // groups
                group_of = np.arange(sc.shape[0]) // count
            return {"scale": sc, "bias": bi, "group_of": group_of.astype(np.int32),
                    "count": count, "offset": offset}

        def conv1(src, kind, packed_in, packed_out):
            w, b = src["kernel"], src["bias"]
            if kind == "s1":
                if packed_in:
                    w, b = pk.pack_kernel_s1(w), np.tile(b, 4)
            elif kind == "down":
                if packed_in and packed_out:
                    w, b = pk.pack_kernel_s2_packed_out(w), np.tile(b, 4)
                elif packed_in:
                    w = pk.pack_kernel_s2_unpacked_out(w)
                elif packed_out:
                    raise NotImplementedError("unpacked->packed downsample")
            elif kind == "up":
                if packed_out:
                    w, b = pk.pack_kernel_upsample(w), np.tile(b, 4)
            return {"kernel": w, "bias": b}

        def rb(src, sections, is_packed, cout):
            e: Dict[str, Any] = {}
            cin = sum(sections)
            offset = is_packed  # offset-grid res-block convs, the JAX default
            # Block_0 (input may be a packed concat); in offset mode its conv
            # hops to the offset-packed grid and Block_1's conv hops back
            w, b = src["Block_0"]["Conv_0"]["kernel"], src["Block_0"]["Conv_0"]["bias"]
            if offset:
                w = pk.pack_kernel_s1_to_offset(w)
                if len(sections) > 1:
                    w = _unperm(w, pk.pack_input_map(sections))
                b = np.tile(b, 4)
            e["Block_0"] = {"gn": make_gn(src["Block_0"]["GroupNorm_0"], sections, is_packed),
                            "conv": {"kernel": w, "bias": b}}
            w, b = src["Block_1"]["Conv_0"]["kernel"], src["Block_1"]["Conv_0"]["bias"]
            if offset:
                w, b = pk.pack_kernel_s1_from_offset(w), np.tile(b, 4)
            e["Block_1"] = {"gn": make_gn(src["Block_1"]["GroupNorm_0"], (cout,), is_packed,
                                          offset=offset),
                            "conv": {"kernel": w, "bias": b}}
            e["fwa"] = dict(src["FeatureWiseAffine_0"]["Dense_0"])
            if cin != cout:
                w, b = src["Conv_0"]["kernel"], src["Conv_0"]["bias"]
                if is_packed:
                    w, b = s1_cat(w, sections), np.tile(b, 4)
                e["res"] = {"kernel": w, "bias": b}
            return e

        rb_i = ds_i = us_i = 0
        packed["Conv_0"] = conv1(p["Conv_0"], "s1", lp(0), lp(0))
        skips: List[int] = [ic]
        n_in = ic
        for lvl, mult in enumerate(net.channel_mults):
            n_out = ic * mult
            for _ in range(net.res_blocks):
                packed[f"ResnetBlock_{rb_i}"] = rb(p[f"ResnetBlock_{rb_i}"], (n_in,), lp(lvl),
                                                   n_out)
                skips.append(n_out)
                n_in = n_out
                rb_i += 1
            packed[f"Downsample_{ds_i}"] = conv1(p[f"Downsample_{ds_i}"]["Conv_0"], "down",
                                                 lp(lvl), lp(lvl + 1))
            skips.append(n_out)
            ds_i += 1

        packed[f"ResnetBlock_{rb_i}"] = rb(p[f"ResnetBlock_{rb_i}"], (n_in,),
                                           lp(self.num_levels), n_in)
        rb_i += 1

        h_c = n_in
        for ind in reversed(range(self.num_levels)):
            n_ch = ic * net.channel_mults[ind]
            packed[f"ResnetBlock_{rb_i}"] = rb(p[f"ResnetBlock_{rb_i}"], (h_c, skips.pop()),
                                               lp(ind + 1), n_ch)
            h_c = n_ch
            rb_i += 1
            packed[f"Upsample_{us_i}"] = conv1(p[f"Upsample_{us_i}"]["Conv_0"], "up",
                                               lp(ind + 1), lp(ind))
            us_i += 1
            n_out = ic if ind == 0 else ic * net.channel_mults[ind - 1]
            for _ in range(net.res_blocks):
                packed[f"ResnetBlock_{rb_i}"] = rb(p[f"ResnetBlock_{rb_i}"],
                                                   (h_c, skips.pop()), lp(ind), n_out)
                h_c = n_out
                rb_i += 1

        w, b = p["Block_0"]["Conv_0"]["kernel"], p["Block_0"]["Conv_0"]["bias"]
        gn = make_gn(p["Block_0"]["GroupNorm_0"], (h_c,), lp(0))
        if lp(0):
            w, b = pk.pack_kernel_s1(w), np.tile(b, 4)
        packed["Block_0"] = {"gn": gn, "conv": {"kernel": w, "bias": b}}

        tree = _torch_tree(packed)
        self._install(tree, next(net.parameters()).device)
        return tree

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
        self._masks.clear()

    def prepare(self) -> Dict:
        """The packed tree for one ``SDDM.infer``: conv and dense weights cast
        to the compute dtype once (not once per step), GroupNorm sites as
        their :class:`_GN` modules (f32 affine)."""
        dt = self.net.dtype

        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            kind, name = node
            return self.gns[name] if kind == "gn" else getattr(self, name).to(dt)

        return build(self._layout)

    def _offset_mask(self, y: torch.Tensor) -> torch.Tensor:
        key = (tuple(y.shape[1:]), y.dtype, y.device)
        if key not in self._masks:
            h, w, c4 = y.shape[1:]
            self._masks[key] = torch.from_numpy(pk.offset_mask(h, w, c4 // 4)).to(y.device,
                                                                                 y.dtype)
        return self._masks[key]

    # -- forward ----------------------------------------------------------------
    def forward(self, condition: torch.Tensor, x_t: torch.Tensor, noise_level: torch.Tensor,
                prep: Dict | None = None) -> torch.Tensor:
        """condition, x_t: ``[B, 1, T]``; noise_level: any shape flattening to
        ``[B]``; ``prep``: :meth:`prepare`'s tree (made here when not given).
        Returns the predicted noise ``[B, 1, T]``."""
        net = self.net
        pp = self.prepare() if prep is None else prep
        in_dtype, dt = x_t.dtype, net.dtype
        lp = lambda level: level < self.packed_levels  # noqa: E731

        cond_f = frame_signal(condition[:, 0], net.segment_len, net.segment_stride)
        xt_f = frame_signal(x_t[:, 0], net.segment_len, net.segment_stride)
        h = torch.stack([cond_f, xt_f], dim=-1).to(dt)  # NHWC [B, N, F, 2]
        h = pk.s2d(h) if lp(0) else h.contiguous()

        # noise MLP: PositionalEncoding, Dense, silu, Dense, silu
        nl = noise_level.to(dt)
        half = net.inner_channel // 2
        step = np.arange(half, dtype=np.float32)
        vec = torch.as_tensor(1e4 * 10.0 ** (-step * 4.0 / half), dtype=dt, device=nl.device)
        enc = nl.reshape(-1, 1) * vec[None, :]
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
