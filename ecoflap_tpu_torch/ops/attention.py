"""Attention over head-split tensors (port of ``ecoflap_tpu/ops/attention.py``).

Three paths compute one function, softmax(Q Kᵀ · sm_scale + bias) V:

* ``flash``   -- the hand-written Hopper kernels ``csrc/flash_attn.cu``
  (forward) and ``csrc/flash_attn_bwd.cu`` (backward: dQ, then dK/dV),
  wrapper ``flash_attention``, a ``torch.autograd.Function`` when an input
  requires grad: causal, bias-free, bf16 in, float32 online softmax, key
  tiles above the diagonal skipped. They replace the Pallas TPU library
  kernels that ``_flash`` calls (attention.py:189-195), forward and
  backward; ``flash_attention_ref``, ``flash_attention_lse_ref`` and
  ``flash_attention_bwd_ref`` are their plain versions.
* ``chunked`` -- online softmax over key chunks in plain PyTorch, float32
  running max, sum and accumulator (attention.py:111-161); O(S·chunk) score
  memory.
* ``naive``   -- the full score tensor, bit for bit what
  ``models/layers.py:attention`` computes (attention.py:92-108).

Mode resolution follows the JAX package's auto rule with the card in the
TPU's place, from device, dtype and shapes alone: flash for a CUDA bf16
tensor whose shapes are flash-eligible, chunked for sequences of 1024 and
more, naive below that. A caller (the tests) forces a path with ``mode=``;
the JAX package's ``ECOFLAP_ATTN`` override has no counterpart, so nothing
outside the call can steer the card around the kernel. ``flash_block_sizes`` (attention.py:164-186)
is a table of TPU tiles and has no counterpart: the CUDA kernels' tiles are
fixed (forward: 128 query rows against 128-key tiles; backward: 128 owned
rows against 64-row tiles), and they take any S % 64 == 0.

Scale: the kernel and its plain version multiply the float32 scores by
``sm_scale``, as the TPU library does; ``_chunked`` and ``_naive`` scale the
queries first, in their dtype, as the JAX package's own paths do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_CHUNK_MIN_SEQ = 1024  # below this the naive score tensor is cheap
_KV_CHUNK = 512
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the TPU library's
FLASH_HEAD_DIM = 128
FLASH_TILE = 64


def _flash_eligible(qh: torch.Tensor, kh: torch.Tensor, causal: bool,
                    bias: Optional[torch.Tensor]) -> bool:
    """The flash path wants no ad-hoc bias (causality comes from tile
    skipping), equal block-divisible sequence lengths and a 128-multiple head
    dimension (attention.py:52-64)."""
    sq, dh = qh.shape[2], qh.shape[3]
    sk = kh.shape[2]
    return (bias is None and causal and sq == sk and sq % 512 == 0
            and dh % 128 == 0)


def resolve_mode(qh: torch.Tensor, kh: torch.Tensor, causal: bool,
                 bias: Optional[torch.Tensor]) -> str:
    if (qh.device.type == "cuda" and qh.dtype == torch.bfloat16
            and _flash_eligible(qh, kh, causal, bias)):
        return "flash"
    if qh.shape[2] >= _CHUNK_MIN_SEQ and kh.shape[2] >= _CHUNK_MIN_SEQ:
        return "chunked"
    return "naive"


def _causal_bias(sq: int, sk: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The models' causal bias, 0 on and below the diagonal, -1e9 above,
    shaped (1, 1, sq, sk)."""
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=device)
    return torch.where(keep, zero, neg)[None, None].to(dtype)


def _naive(qh, kh, vh, sm_scale, bias, causal):
    """Scores in the query dtype, additive biases, float32 softmax, probs in
    the value dtype, one rounding of P V to the query dtype."""
    scores = torch.matmul(qh * sm_scale, kh.transpose(-1, -2))
    if causal:
        scores = scores + _causal_bias(qh.shape[2], kh.shape[2], scores.dtype,
                                       scores.device)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(vh.dtype)
    return torch.matmul(probs, vh).to(qh.dtype)


def _chunked(qh, kh, vh, sm_scale, bias, causal, kv_chunk):
    """The flash recurrence over key chunks: running max m, denominator l
    and accumulator acc, all float32. A ragged last chunk falls back to
    ``_naive`` rather than pad and mask."""
    b, h, sq, dh = qh.shape
    sk = kh.shape[2]
    kv_chunk = min(kv_chunk, sk)
    if sk % kv_chunk:
        return _naive(qh, kh, vh, sm_scale, bias, causal)
    qf = (qh * sm_scale).to(torch.float32)
    if bias is not None:
        bias = bias.to(torch.float32).expand(bias.shape[0], bias.shape[1], sq, sk)
    q_pos = torch.arange(sq, device=qh.device)[:, None]
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=qh.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=qh.device)
    for j in range(sk // kv_chunk):
        sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
        s = torch.matmul(qf, kh[:, :, sl].to(torch.float32).transpose(-1, -2))
        if bias is not None:
            s = s + bias[..., sl]
        if causal:
            k_pos = j * kv_chunk + torch.arange(kv_chunk, device=qh.device)[None, :]
            s = s + torch.where(q_pos >= k_pos, 0.0, -1e9)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vh[:, :, sl].to(torch.float32))
        m = m_new
    return (acc / l[..., None]).to(qh.dtype)


# -- the kernels ---------------------------------------------------------------

def _masked_scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """float32 Q Kᵀ · sm_scale with the causal mask at ``MASK_VALUE``."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s * float(sm_scale)
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~keep, MASK_VALUE)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Plain version of the forward kernel: float32 scores times
    ``sm_scale``, the causal mask at ``MASK_VALUE``, float32 softmax and P V,
    one rounding to the input dtype. It materialises the (B, H, S, S)
    scores."""
    p = torch.softmax(_masked_scores(q, k, sm_scale), dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            sm_scale: float):
    """Plain version of the forward kernel when it also writes the row
    log-sum-exp: (output in the input dtype, float32 (B, H, S) LSE in
    natural-log units, the one convention of the kernels and their plain
    versions)."""
    s = _masked_scores(q, k, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            sm_scale: float):
    """Plain version of the backward kernels: (dq, dk, dv) from the inputs,
    the output, its LSE and the output's cotangent ``do``, all in float32
    with one rounding to the input dtype:
    P = exp(S · sm_scale - LSE), dV = Pᵀ dO, dS = P ∘ (dO Vᵀ - rowsum(O ∘ dO)),
    dQ = dS K · sm_scale, dK = dSᵀ Q · sm_scale."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = do.to(torch.float32)
    p = torch.exp(_masked_scores(q, k, sm_scale) - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    di = (o.to(torch.float32) * dof).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di)
    dq = torch.matmul(ds, kf) * float(sm_scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * float(sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The C entries' signatures: pointers, (B, H, S, Dh), each tensor's (batch,
# head, sequence) strides, sm_scale and the stream.
FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 12
                + [ctypes.c_float, ctypes.c_void_p])
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 24
                + [ctypes.c_float, ctypes.c_void_p])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the flash entries' argument and result types on ``lib`` (a
    build of ``csrc/flash_attn.cu`` or ``csrc/flash_attn_bwd.cu``)."""
    for name, argtypes in (("ecoflap_flash_attn_fwd", FWD_ARGTYPES),
                           ("ecoflap_flash_attn_bwd", BWD_ARGTYPES)):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ecoflap_tpu_torch.ops.build import load

    return bind(load("flash_attn"))


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from ecoflap_tpu_torch.ops.build import load

    return bind(load("flash_attn_bwd"))


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be a (B, H, S, Dh) tensor")
    if not (q.shape == k.shape == v.shape):
        raise ValueError("flash_attention needs q, k, v of one shape with "
                         f"sq == sk; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v differ in dtype")


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` in place: a contiguous head
    dimension and rows on 16-byte boundaries."""
    return t.stride(3) == 1 and not any(st % 8 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check_cuda(q: torch.Tensor, tensors) -> None:
    """What both kernels take: bf16, Dh = 128, S % 64 == 0, B * H <= 65535,
    and every tensor readable in place."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, s, dh = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel takes bfloat16, got {q.dtype}")
    if dh != FLASH_HEAD_DIM or s % FLASH_TILE:
        raise ValueError(f"the flash kernel needs Dh == {FLASH_HEAD_DIM} and "
                         f"S % {FLASH_TILE} == 0, got {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"the flash kernel takes B * H <= 65535, got {b * h}")
    for name, t in tensors:
        if not _kernel_layout(t):
            raise ValueError(
                f"flash_attention: {name} needs a contiguous head dimension and "
                f"16-byte aligned rows; strides {t.stride()}")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
             with_lse: bool):
    """(output, LSE or None): the plain version on a CPU tensor, else one
    launch of the forward kernel, counted in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_lse_ref(q, k, v, sm_scale)
        return flash_attention_ref(q, k, v, sm_scale), None
    _check_cuda(q, (("q", q), ("k", k), ("v", v)))
    b, h, s, dh = q.shape
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _lib().ecoflap_flash_attn_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, h, s, dh, *strides,
            ctypes.c_float(float(sm_scale)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float):
    """(output, float32 (B, H, S) LSE) of causal flash attention: the
    forward kernel with its LSE output, counted in
    ``flash_attention.launches``, or its plain version on a CPU tensor.
    ``flash_attention`` runs it when a gradient is wanted."""
    _check_flash(q, k, v)
    return _forward(q, k, v, sm_scale, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        sm_scale: float):
    """(dq, dk, dv) of causal flash attention, given the forward's output
    ``o`` and float32 (B, H, S) ``lse``, and the output's cotangent ``do``.

    A CPU tensor takes the plain version. A CUDA tensor launches the two
    backward kernels of ``csrc/flash_attn_bwd.cu`` (dQ, which also reduces
    rowsum(O ∘ dO), then dK/dV), counted once a call in
    ``flash_attention_bwd.launches``, or raises. The kernels read every
    input through its strides; ``do`` comes from autograd, so one that the
    kernels cannot read in place (a non-contiguous head dimension, an
    expanded zero) is first copied to a contiguous tensor. The outputs are
    new contiguous tensors."""
    _check_flash(q, k, v)
    if not (o.shape == do.shape == q.shape and lse.shape == q.shape[:3]):
        raise ValueError("flash_attention_bwd: o and do must have q's shape and "
                         f"lse its first three dimensions; got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("flash_attention_bwd: o, lse and do must lie on q's device")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, sm_scale)
    if not (o.dtype == do.dtype == q.dtype) or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: o and do must be in q's dtype and "
                        "lse float32")
    if not _kernel_layout(do):
        do = do.contiguous()
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous")
    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _bwd_lib().ecoflap_flash_attn_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse), _ptr(di),
            _ptr(dq), _ptr(dk), _ptr(dv), b, h, s, dh, *strides,
            ctypes.c_float(float(sm_scale)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: cudaError_t {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttentionFn(torch.autograd.Function):
    """Forward: the kernel with its LSE output; backward: the two backward
    kernels (the library's custom_vjp, flash_attention.py:204, 318). On CPU
    tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_attention_lse(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Causal softmax(Q Kᵀ · sm_scale) V over (B, H, S, Dh) tensors.

    A CPU tensor takes the plain versions. A CUDA tensor launches the kernel
    or raises: it must be bf16 with Dh = 128 and S % 64 == 0. The kernel
    reads q, k and v through their strides (the head dimension contiguous,
    rows on 16-byte boundaries), so the model's transposed (B, S, H, Dh)
    views go in without a copy; the output is a new contiguous tensor. When
    grad is enabled and an input requires it, the forward also writes the
    row LSE and the backward runs ``flash_attention_bwd``; otherwise it
    writes the output alone. ``flash_attention.launches`` counts forward
    launches on the card."""
    _check_flash(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, sm_scale)
    return _forward(q, k, v, sm_scale, with_lse=False)[0]


flash_attention.launches = 0


def mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *,
        sm_scale: float = 1.0, bias: Optional[torch.Tensor] = None,
        causal: bool = False, mode: Optional[str] = None,
        kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """Multi-head attention over head-split tensors.

    Args:
      qh/kh/vh: (B, H, S, Dh). GQA callers repeat the KV heads beforehand.
      sm_scale: score scale (Dh^-0.5 for standard attention, 1.0 for T5).
      bias: additive score bias broadcastable to (B, H, Sq, Sk); pure-causal
        callers pass bias=None and causal=True so flash stays eligible.
      causal: causal masking (on top of ``bias`` if both are given).
      mode: force a path; None resolves it (``resolve_mode``).
    """
    if mode is None:
        mode = resolve_mode(qh, kh, causal, bias)
    if mode == "flash":
        if not _flash_eligible(qh, kh, causal, bias):
            raise ValueError(
                "flash attention requires causal, bias-free, block-divisible "
                f"shapes (q {tuple(qh.shape)}, k {tuple(kh.shape)}, causal={causal})")
        return flash_attention(qh, kh, vh, sm_scale)
    if mode == "chunked":
        return _chunked(qh, kh, vh, sm_scale, bias, causal, kv_chunk)
    if mode == "naive":
        return _naive(qh, kh, vh, sm_scale, bias, causal)
    raise ValueError(f"unknown attention mode {mode!r}")
