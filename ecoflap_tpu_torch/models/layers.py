"""Building blocks shared by the BLIP-2 towers, with the JAX package's
numerics (``ecoflap_tpu/models/layers.py``).

Weights are in the torch ``(out, in)`` layout. Every prunable linear goes
through ``dense(..., name=, stats=, collect=)``, which folds the Wanda
statistic (sum of x^2 per input column, float32) or the SparseGPT Gram
matrix X^T X into ``stats`` while computing the product -- the inline
replacement for the reference's forward hooks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ecoflap_tpu_torch.ops.attention import mha

Stats = Optional[Dict[str, torch.Tensor]]


def collect_stats(stats: Stats, name: Union[str, Sequence[str]],
                  x: torch.Tensor, collect: Optional[str]) -> None:
    """Fold the statistic of the linear ``name``'s input ``x`` into
    ``stats``, raw float32 sums: ``"wanda"`` the sum of x^2 per input column,
    ``"hessian"`` the (in, in) Gram matrix X^T X (SparseGPT). A sequence of
    names shares one tensor: linears that read the same input."""
    if stats is None or collect is None:
        return
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if collect == "wanda":
        contrib = flat.square().sum(dim=0)
    elif collect == "hessian":
        contrib = flat.T @ flat
    else:
        raise ValueError(f"unknown collect mode {collect!r}")
    for n in ((name,) if isinstance(name, str) else name):
        stats[n] = stats[n] + contrib if n in stats else contrib


def dense(lin: torch.nn.Linear, x: torch.Tensor, *, name: str = "",
          stats: Stats = None, collect: Optional[str] = None) -> torch.Tensor:
    """y = x W^T + b in the activation dtype: the bias joins the float32
    accumulator before the one rounding (layers.py:51-54)."""
    collect_stats(stats, name, x, collect)
    return F.linear(x, lin.weight, lin.bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm computed in float32, cast back to the input dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 RMSNorm (no mean subtraction, no bias), float32 inside."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


class Bf16LogitsF32(torch.autograd.Function):
    """x Wᵀ of bf16 operands with float32 output on the card:
    ``torch.mm(..., out_dtype=float32)``, which has no derivative of its own.
    The backward is the JAX transpose of a ``preferred_element_type=float32``
    dot: the float32 cotangent against the widened weight, one rounding to
    x's dtype. The lm_head is frozen, so W gets no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        flat = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return flat.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the lm_head weight takes no gradient")
        (w,) = ctx.saved_tensors
        gx = torch.matmul(g.to(torch.float32), w.to(torch.float32))
        return gx.to(torch.bfloat16), None


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x Wᵀ with float32 logits from the stored values: products summed in
    float32 and never rounded to the weight dtype (the JAX dot's
    ``preferred_element_type=float32``). On the card a bf16 product keeps
    the tensor cores through ``out_dtype`` (``Bf16LogitsF32``, which also
    differentiates it); elsewhere both operands are widened, which computes
    the same sums."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return Bf16LogitsF32.apply(x, w)
    return F.linear(x.to(torch.float32), w.to(torch.float32))


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def extract_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) NHWC image -> (B, N, C*patch*patch), patch pixels ordered
    (C, ph, pw) like a Conv2d weight flattened."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Sk) 0/1 mask -> (B, 1, 1, Sk) float32 additive bias; -1e9 rather
    than -inf so an all-pad row softmaxes to uniform, not NaN."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, neg)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, scale: Optional[float] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over merged heads, (B, S, H*Dh) in and out:
    ``ops.attention.mha`` in its naive mode, the JAX package's ``_naive``
    (ops/attention.py:92-108) -- scores of the scaled queries in the query
    dtype, additive bias, float32 softmax, probs x V."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    dh = q.shape[-1] // num_heads
    if scale is None:
        scale = dh ** -0.5
    qh = q.reshape(b, sq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, sk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, sk, num_heads, dh).transpose(1, 2)
    out = mha(qh, kh, vh, sm_scale=scale, bias=bias, mode="naive")
    return out.transpose(1, 2).reshape(b, sq, num_heads * dh)
