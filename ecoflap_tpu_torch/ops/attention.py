"""Attention over head-split tensors (port of ``ecoflap_tpu/ops/attention.py``).

Three paths compute one function, softmax(Q Kᵀ · sm_scale + bias) V:

* ``flash``   -- the hand-written Hopper kernel ``csrc/flash_attn.cu``
  (wrapper ``flash_attention``): causal, bias-free, bf16 in, float32
  online softmax, key tiles above the diagonal skipped. It replaces the
  Pallas TPU library kernel that ``_flash`` calls (attention.py:189-195),
  forward only; ``flash_attention_ref`` is its plain version.
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
is a table of TPU tiles and has no counterpart: the CUDA kernel's tiles are
fixed at 64 x 64.

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


# -- the kernel ----------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Plain version of the kernel: float32 scores times ``sm_scale``, the
    causal mask at ``MASK_VALUE``, float32 softmax and P V, one rounding to
    the input dtype. It materialises the (B, H, S, S) scores."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s * float(sm_scale)
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
    s = s.masked_fill(~keep, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ecoflap_tpu_torch.ops.build import load

    lib = load("flash_attn")
    lib.ecoflap_flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 12
        + [ctypes.c_float, ctypes.c_void_p])
    lib.ecoflap_flash_attn_fwd.restype = ctypes.c_int
    return lib


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be a (B, H, S, Dh) tensor")
        if t.requires_grad:
            raise NotImplementedError(
                "flash_attention is forward only: its backward is ported with "
                "first-order scoring on LLaMA (ROADMAP.md)")
    if not (q.shape == k.shape == v.shape):
        raise ValueError("flash_attention needs q, k, v of one shape with "
                         f"sq == sk; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v differ in dtype")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Causal softmax(Q Kᵀ · sm_scale) V over (B, H, S, Dh) tensors.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises: it must be bf16 with Dh = 128 and S % 64 == 0. The kernel
    reads q, k and v through their strides (the head dimension contiguous,
    rows on 16-byte boundaries), so the model's transposed (B, S, H, Dh)
    views go in without a copy; the output is a new contiguous tensor."""
    _check_flash(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, sm_scale)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} needs a contiguous head dimension and "
                f"16-byte aligned rows; strides {t.stride()}")
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _lib().ecoflap_flash_attn_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, h, s, dh, *strides, ctypes.c_float(float(sm_scale)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    return out


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
