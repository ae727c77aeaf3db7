"""Quantized 2-D convolution (counterpart of `repro.core.qconv`).

A convolution is made an explicit GEMM: patches are extracted with
`F.unfold`, then the (patches x filters) product runs through `qeinsum`
('bhwk,kn->bhwn'), so the W/A/E/G Q nodes cover convolutions with the
dataflow of a dense layer. Under a kernel backend at unit scales (the
paper's recipe) the forward GEMM is the fp8 GEMM kernel (kernels.
fp8_matmul); the adjoint GEMMs are the unfused qeinsum's f32 products. The
patch extraction and its backward (`F.fold`, through autograd) move
values and stay unquantized, as in the reference.

Layouts are the reference's: x (B, H, W, C_in), filters HWIO (kh, kw,
C_in, C_out), so weights carry across as they are. SAME padding is the
reference's (XLA's): a total of max((out - 1) * s + k - in, 0) with the
smaller half before, which at stride 2 on an even input pads (0, 1), not
the (1, 1) of `F.unfold(padding=1)`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision_policy import PAPER_FP8, QuantConfig
from repro_torch.core.qlinear import qeinsum


def conv_init(kh: int, kw: int, c_in: int, c_out: int, *,
              generator: torch.Generator, device) -> torch.Tensor:
    """He-scaled truncated normal (+-2 sigma), f32, HWIO — the reference's
    initializer (its numbers come from jax.random, these from
    `generator`)."""
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    w = torch.empty((kh, kw, c_in, c_out), dtype=torch.float32,
                    device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def _pads(size: int, k: int, s: int, padding: str) -> Tuple[int, int, int]:
    """(output size, pad before, pad after) of one spatial axis."""
    if padding == "VALID":
        return (size - k) // s + 1, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                         f"{padding!r}")
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2, total - total // 2


def patches(x: torch.Tensor, kh: int, kw: int,
            stride: Tuple[int, int] = (1, 1),
            padding: str = "SAME") -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', C * kh * kw), the channels ordered
    (C, kh, kw) as `lax.conv_general_dilated_patches` orders them."""
    b, h, w, c = x.shape
    ho, top, bottom = _pads(h, kh, stride[0], padding)
    wo, left, right = _pads(w, kw, stride[1], padding)
    # Unfolded in f32 (the values are only moved, so equal to x's): the
    # backward's fold then sums overlapping patch gradients in f32 and
    # rounds once to x's dtype, as the reference's transposed extraction
    # does.
    xc = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    cols = F.unfold(xc, (kh, kw), stride=stride)       # (B, C*kh*kw, L)
    return cols.transpose(1, 2).reshape(b, ho, wo, c * kh * kw).to(x.dtype)


def qconv2d(x: torch.Tensor, w: torch.Tensor, *,
            stride: Tuple[int, int] = (1, 1), padding: str = "SAME",
            cfg: QuantConfig = PAPER_FP8, site: Optional[str] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: (B, H, W, C_in), w: (kh, kw, C_in, C_out) -> (B, H', W', C_out)
    in the config's output dtype. SR bits come from `generator`."""
    kh, kw, c_in, c_out = w.shape
    p = patches(x, kh, kw, tuple(stride), padding)
    w_flat = w.permute(2, 0, 1, 3).reshape(c_in * kh * kw, c_out)
    return qeinsum("bhwk,kn->bhwn", p, w_flat, cfg=cfg, site=site,
                   generator=generator)
