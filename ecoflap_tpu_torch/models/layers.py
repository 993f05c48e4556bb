"""Building blocks shared by the BLIP-2 towers, with the JAX package's
numerics (``ecoflap_tpu/models/layers.py``).

Weights are in the torch ``(out, in)`` layout. Every prunable linear goes
through ``dense(..., name=, stats=, collect=)``, which folds the Wanda
statistic (sum of x^2 per input column, float32) or the SparseGPT Gram
matrix X^T X into ``stats`` while computing the product -- the inline
replacement for the reference's forward hooks.

Every product with a weight that the tensor-parallel rules match goes
through ``linear`` (or ``linear_f32`` for float32 logits, ``embedding`` for
a lookup). Outside a mesh they are ``F.linear`` / ``logits_f32`` /
``F.embedding`` exactly. On a weight that ``parallel.sharding.shard_params``
split over tp, activations stay whole on every rank:

* column-parallel (out dim sharded): the local product with this rank's
  slice of the bias, then an all-gather along the last dim;
* row-parallel (in dim sharded): this rank's slice of ``x``'s last dim,
  the local product with float32 output, an all-reduce in float32, then
  the bias, and one rounding to ``x``'s dtype (bf16 partials rounded before
  the sum would round tp times);
* a lookup in a table sharded along ``d``: the local lookup, all-gathered.

The collectives carry Megatron's conjugate backwards (``parallel.mesh``):
gather -> slice, slice -> gather, all-reduce -> identity, and the
replicated input of a column-parallel product takes the all-reduce of the
ranks' partial gradients.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ecoflap_tpu_torch.ops.attention import mha
from ecoflap_tpu_torch.parallel.mesh import (
    copy_reduce,
    gather_reduce_slice,
    gather_slice,
    rank_slice,
    reduce_copy,
    slice_gather,
)
from ecoflap_tpu_torch.parallel.sharding import shard_of

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


_UNSET = object()


def linear(x: torch.Tensor, module: torch.nn.Module, bias=_UNSET, *,
           weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b in the activation dtype, W = ``module.weight``
    (``weight``, when given, is that parameter reshaped to 2-D, e.g. a patch
    embedding's kernel), b = ``module.bias`` unless ``bias`` is given (the
    whole vector). Joins the ranks' products when W is sharded over tp."""
    w = module.weight if weight is None else weight
    b = getattr(module, "bias", None) if bias is _UNSET else bias
    sh = shard_of(module)
    if sh is None:
        return F.linear(x, w, b)
    if sh.dim == 0:  # column-parallel
        b = None if b is None else rank_slice(b, 0, sh.rank, sh.size)
        y = F.linear(copy_reduce(x, sh.group), w, b)
        return gather_slice(y, -1, sh.group, sh.size, sh.rank)
    xs = slice_gather(x, -1, sh.group, sh.size, sh.rank)  # row-parallel
    # float32 partials; a shard being trained takes the widened product,
    # whose autograd gives its gradient (Bf16LogitsF32 gives none)
    part = (F.linear(xs.to(torch.float32), w.to(torch.float32)) if w.requires_grad
            else logits_f32(xs, w))
    y = reduce_copy(part, sh.group)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def linear_f32(x: torch.Tensor, module: torch.nn.Module, *,
               widen: bool = False) -> torch.Tensor:
    """float32 x W^T (logits), W = ``module.weight``: ``logits_f32``, or with
    ``widen`` both operands widened to float32 first; over tp the local
    float32 products are gathered (W's out dim sharded) or summed (its in
    dim)."""
    w = module.weight
    sh = shard_of(module)

    def local(xx):
        if widen:
            return F.linear(xx.to(torch.float32), w.to(torch.float32))
        return logits_f32(xx, w)

    if sh is None:
        return local(x)
    if sh.dim == 0:
        return gather_slice(local(copy_reduce(x, sh.group)), -1, sh.group, sh.size,
                            sh.rank)
    return reduce_copy(local(slice_gather(x, -1, sh.group, sh.size, sh.rank)),
                       sh.group)


def embedding(ids: torch.Tensor, module: torch.nn.Embedding) -> torch.Tensor:
    """``module(ids)``; a table sharded along ``d`` looks up its slice and
    gathers the rows along the last dim."""
    sh = shard_of(module)
    if sh is None:
        return module(ids)
    return gather_slice(F.embedding(ids, module.weight), -1, sh.group, sh.size,
                        sh.rank)


def full_param(module: torch.nn.Module, pname: str) -> torch.Tensor:
    """``module.<pname>`` whole: gathered over tp when it is sharded
    (differentiable: each rank's slice takes the ranks' summed gradient)."""
    p = getattr(module, pname)
    sh = shard_of(module, pname)
    if sh is None:
        return p
    return gather_reduce_slice(p, sh.dim, sh.group, sh.size, sh.rank)


def dense(lin: torch.nn.Linear, x: torch.Tensor, *, name: str = "",
          stats: Stats = None, collect: Optional[str] = None) -> torch.Tensor:
    """y = x W^T + b in the activation dtype: the bias joins the float32
    accumulator before the one rounding (layers.py:51-54). The statistic
    reads the whole input, on every tp rank alike."""
    collect_stats(stats, name, x, collect)
    return linear(x, lin)


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
