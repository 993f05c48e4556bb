"""How the plain reference multiplies: float32 with TF32 off, or, for the
control, every product's two operands rounded to float8 e4m3 first.

The control is the reference computed one precision below the bfloat16
that the configurations state: each operand of each matrix product is
scaled by its own absolute maximum to e4m3's largest value (448), rounded
to e4m3 and scaled back, as a per-tensor scaled fp8 GEMM would see it. All
other arithmetic (norms, softmax, sums) stays float32 in both.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def exact_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    """``mode`` "f32" (the reference) or "fp8" (the control)."""

    def __init__(self, mode: str = "f32") -> None:
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in float32, through e4m3 in the control."""
        t = t.to(torch.float32)
        if self.mode == "f32":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x W^T + b, W in the torch (out, in) layout."""
        y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b.to(torch.float32)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


def layer_norm(x, w, b, eps):
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * w.to(torch.float32)
    return y if b is None else y + b.to(torch.float32)


def rms_norm(x, w, eps):
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def attention(p: Prec, q, k, v, heads: int, scale: float, bias=None):
    """softmax(q k^T scale + bias) v over merged heads, (B, S, H*Dh)."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, sq, heads, -1).transpose(1, 2)
    kh = k.reshape(b, sk, heads, -1).transpose(1, 2)
    vh = v.reshape(b, sk, heads, -1).transpose(1, 2)
    s = p.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    o = p.matmul(torch.softmax(s, dim=-1), vh)
    return o.transpose(1, 2).reshape(b, sq, -1)


def extract_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, C*patch*patch), pixels ordered (C, ph, pw) as a
    Conv2d weight flattens."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 0/1 key mask -> (B, 1, 1, S) additive float32 bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
