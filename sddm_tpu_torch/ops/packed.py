"""Space-to-depth ("packed") convolution transforms (counterpart of the
host-side part of ``sddm_tpu/ops/packed.py``).

A level-l activation ``[B, N, F, C]`` of UNetModified2 is carried as
``[B, N/2, F/2, 4C]`` with packed channel ``phase * C + c``, ``phase = 2 *
(row parity) + (col parity)``.  Every convolution of the network maps to a
convolution on packed tensors whose kernel is a fixed sparse rearrangement
of the original kernel; the numpy functions below make those kernels once on
the host, in the HWIO layout ``[kh, kw, Ci, Co]`` of the JAX package, and
:class:`sddm_tpu_torch.models.unet_packed.PackedUNetModified2` turns them
into torch's OIHW.  ``s2d``/``d2s`` work on NHWC torch tensors.

Derivations (0-based taps t = dh+1; a/a' are row parities of the output /
input position, e is the packed-space tap offset):
  - stride-1 3x3 SAME:   dh = 2(e-1) + a' - a,  e in {0,1,2}  -> 3x3 packed
  - stride-2 3x3 pad 1, packed->unpacked half grid:
                         dh = 2(e-1) + a',      e in {0,1}    -> 2x2, pad (1,0)
  - stride-2 3x3 pad 1, packed->packed quarter grid:
                         dh = 2(e-1) + a' - 2a, e in {0,1,2}  -> 3x3 s2 pad 1
  - nearest-2x-up + 3x3 SAME, unpacked->packed (same grid): the taps each
    input pixel reaches through both duplicated rows are summed.
"""

from __future__ import annotations

import numpy as np
import torch


def s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, N, F, C] -> [B, N/2, F/2, 4C], packed channel = phase*C + c."""
    b, n, f, c = x.shape
    x = x.reshape(b, n // 2, 2, f // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, N/2, F/2, a, b, C]
    return x.reshape(b, n // 2, f // 2, 4 * c)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`."""
    b, n2, f2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, n2, f2, 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, N/2, a, F/2, b, C]
    return x.reshape(b, n2 * 2, f2 * 2, c)


def _phase_index(a: int, b: int, c: np.ndarray, n_ch: int) -> np.ndarray:
    return (2 * a + b) * n_ch + c


def pack_kernel_s1(w: np.ndarray) -> np.ndarray:
    """Stride-1 SAME 3x3 (or 1x1) kernel [kh, kw, Ci, Co] ->
    packed [3, 3, 4Ci, 4Co] (or [1, 1, 4Ci, 4Co] for 1x1):
    conv(x, w, SAME) == d2s(conv(s2d(x), w', SAME))."""
    kh, kw, ci, co = w.shape
    if (kh, kw) == (1, 1):
        out = np.zeros((1, 1, 4 * ci, 4 * co), w.dtype)
        for p in range(4):
            out[0, 0, p * ci:(p + 1) * ci, p * co:(p + 1) * co] = w[0, 0]
        return out
    assert (kh, kw) == (3, 3), "only 1x1 and 3x3 stride-1 kernels"
    out = np.zeros((3, 3, 4 * ci, 4 * co), w.dtype)
    rng_ci, rng_co = np.arange(ci), np.arange(co)
    for e in range(3):
        for f in range(3):
            for a_in in range(2):
                for b_in in range(2):
                    for a in range(2):
                        for b in range(2):
                            dh = 2 * (e - 1) + a_in - a
                            dw = 2 * (f - 1) + b_in - b
                            if not (-1 <= dh <= 1 and -1 <= dw <= 1):
                                continue
                            pi = _phase_index(a_in, b_in, rng_ci, ci)
                            po = _phase_index(a, b, rng_co, co)
                            out[e, f, pi[:, None], po[None, :]] = w[dh + 1, dw + 1]
    return out


def pack_kernel_s1_to_offset(w: np.ndarray) -> np.ndarray:
    """Stride-1 SAME 3x3 kernel [3, 3, Ci, Co] -> [2, 2, 4Ci, 4Co], consumed
    with padding (1,1) on a STANDARD-packed input and producing the
    OFFSET-packed grid (offset block i = plain rows {2i-1, 2i}, one extra
    block per spatial axis; plain rows -1 and H land at block 0 phase 0 /
    the last block phase 1 and are masked downstream, :func:`offset_mask`).
    9/16 of it is nonzero, against 1/4 for :func:`pack_kernel_s1`.
    Output offset block i phase a is plain row 2i-1+a; tap e in {0,1} reads
    standard block i-1+e phase a_in, so dh = 2(e-1) + a_in - a + 1."""
    kh, kw, ci, co = w.shape
    assert (kh, kw) == (3, 3), "offset packing is for 3x3 stride-1 kernels"
    out = np.zeros((2, 2, 4 * ci, 4 * co), w.dtype)
    rng_ci, rng_co = np.arange(ci), np.arange(co)
    for e in range(2):
        for f in range(2):
            for a_in in range(2):
                for b_in in range(2):
                    for a in range(2):
                        for b in range(2):
                            dh = 2 * (e - 1) + a_in - a + 1
                            dw = 2 * (f - 1) + b_in - b + 1
                            if not (-1 <= dh <= 1 and -1 <= dw <= 1):
                                continue
                            pi = _phase_index(a_in, b_in, rng_ci, ci)
                            po = _phase_index(a, b, rng_co, co)
                            out[e, f, pi[:, None], po[None, :]] = w[dh + 1, dw + 1]
    return out


def pack_kernel_s1_from_offset(w: np.ndarray) -> np.ndarray:
    """Stride-1 SAME 3x3 kernel [3, 3, Ci, Co] -> [2, 2, 4Ci, 4Co], consumed
    with VALID padding on an OFFSET-packed input (whose out-of-range plain
    rows/cols are zero, the plain conv's SAME padding) and producing the
    STANDARD-packed grid.  Output standard block i phase a is plain row
    2i+a; tap e in {0,1} reads offset block i+e phase a_in, so
    dh = 2e + a_in - a - 1."""
    kh, kw, ci, co = w.shape
    assert (kh, kw) == (3, 3), "offset packing is for 3x3 stride-1 kernels"
    out = np.zeros((2, 2, 4 * ci, 4 * co), w.dtype)
    rng_ci, rng_co = np.arange(ci), np.arange(co)
    for e in range(2):
        for f in range(2):
            for a_in in range(2):
                for b_in in range(2):
                    for a in range(2):
                        for b in range(2):
                            dh = 2 * e + a_in - a - 1
                            dw = 2 * f + b_in - b - 1
                            if not (-1 <= dh <= 1 and -1 <= dw <= 1):
                                continue
                            pi = _phase_index(a_in, b_in, rng_ci, ci)
                            po = _phase_index(a, b, rng_co, co)
                            out[e, f, pi[:, None], po[None, :]] = w[dh + 1, dw + 1]
    return out


def offset_mask(h_off: int, w_off: int, c: int, dtype=np.float32) -> np.ndarray:
    """{0,1} mask [h_off, w_off, 4c] zeroing an OFFSET-packed tensor's two
    out-of-range plain rows/cols (plain row -1 = block 0 phase 0, plain row
    H = last block phase 1; the same per column).  Applied after the
    producing conv, so that GroupNorm statistics see zeros there, and again
    after the nonlinearity, before the consuming VALID conv."""
    mr = np.ones((h_off, 2), dtype)
    mr[0, 0] = 0.0
    mr[-1, 1] = 0.0
    mc = np.ones((w_off, 2), dtype)
    mc[0, 0] = 0.0
    mc[-1, 1] = 0.0
    m4 = np.einsum("ia,jb->ijab", mr, mc).reshape(h_off, w_off, 4)
    return np.repeat(m4, c, axis=-1)


def pack_kernel_s2_unpacked_out(w: np.ndarray) -> np.ndarray:
    """Stride-2 3x3 pad (1,1) kernel [3, 3, Ci, Co] -> packed [2, 2, 4Ci, Co]:
    conv_s2(x, w, pad 1) == conv_s1(s2d(x), w', pad ((1,0),(1,0))), the
    output on the half grid, unpacked."""
    _, _, ci, co = w.shape
    out = np.zeros((2, 2, 4 * ci, co), w.dtype)
    rng_ci = np.arange(ci)
    for e in range(2):
        for f in range(2):
            for a_in in range(2):
                for b_in in range(2):
                    dh = 2 * (e - 1) + a_in
                    dw = 2 * (f - 1) + b_in
                    if not (-1 <= dh <= 1 and -1 <= dw <= 1):
                        continue
                    pi = _phase_index(a_in, b_in, rng_ci, ci)
                    out[e, f, pi] = w[dh + 1, dw + 1]
    return out


def pack_kernel_s2_packed_out(w: np.ndarray) -> np.ndarray:
    """Stride-2 3x3 pad (1,1) kernel [3, 3, Ci, Co] -> packed
    [3, 3, 4Ci, 4Co], applied with stride 2 pad (1,1) on packed input; the
    output is the next level's PACKED representation (quarter grid)."""
    _, _, ci, co = w.shape
    out = np.zeros((3, 3, 4 * ci, 4 * co), w.dtype)
    rng_ci, rng_co = np.arange(ci), np.arange(co)
    for e in range(3):
        for f in range(3):
            for a_in in range(2):
                for b_in in range(2):
                    for a in range(2):
                        for b in range(2):
                            dh = 2 * (e - 1) + a_in - 2 * a
                            dw = 2 * (f - 1) + b_in - 2 * b
                            if not (-1 <= dh <= 1 and -1 <= dw <= 1):
                                continue
                            pi = _phase_index(a_in, b_in, rng_ci, ci)
                            po = _phase_index(a, b, rng_co, co)
                            out[e, f, pi[:, None], po[None, :]] = w[dh + 1, dw + 1]
    return out


def pack_kernel_upsample(w: np.ndarray) -> np.ndarray:
    """Nearest-2x-upsample + 3x3 SAME conv, fused: kernel [3, 3, Ci, Co] ->
    [3, 3, Ci, 4Co] consuming the UN-upsampled (unpacked) input grid and
    producing the PACKED representation of the upsampled grid (the input's
    spatial size).  Nearest duplication feeds each input pixel through two
    adjacent rows, so taps that alias the same source pixel SUM."""
    _, _, ci, co = w.shape
    out = np.zeros((3, 3, ci, 4 * co), w.dtype)
    rng_co = np.arange(co)
    # output packed row i, phase a <=> upsampled row 2i+a; conv tap dh reads
    # upsampled row 2i+a+dh, duplicated from input row i + e-1 with
    # e-1 = floor((a+dh)/2)
    for a in range(2):
        for b in range(2):
            for dh in (-1, 0, 1):
                for dw in (-1, 0, 1):
                    e = (a + dh) // 2 + 1
                    f = (b + dw) // 2 + 1
                    po = _phase_index(a, b, rng_co, co)
                    out[e, f, :, po] += w[dh + 1, dw + 1].T
    return out


def pack_input_map(sections) -> np.ndarray:
    """Channel permutation mapping concat(packed(x1), packed(x2), ...) to
    packed(concat(x1, x2, ...)).

    ``sections``: per-tensor channel counts (c1, c2, ...).  Returns ``perm``
    with packed(concat)[..., j] == concat(packed)[..., perm[j]]."""
    total = sum(sections)
    perm = np.zeros(4 * total, np.int64)
    offsets = np.cumsum([0] + list(sections))
    for phase in range(4):
        for t, c in enumerate(sections):
            # packed(concat) channel = phase*total + offset_t + c_i
            # concat(packed) channel = 4*offset_t + phase*c + c_i
            dst = phase * total + offsets[t] + np.arange(c)
            src = 4 * offsets[t] + phase * c + np.arange(c)
            perm[dst] = src
    return perm
