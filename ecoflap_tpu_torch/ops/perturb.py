"""Gaussian perturbation ``w += scale * z`` (in place) and ``w + scale * z``
(out of place) for MeZO scoring.

Port of ``ecoflap_tpu/ops/perturb.py:perturb_block_inplace`` (the Pallas
kernel ``_perturb_block_kernel``) and of ``perturb`` (``_perturb_kernel``),
the two entries of one CUDA source (``csrc/perturb.cu``). The kernel
draws z from a counter-based Philox4x32-10 keyed by a 64-bit seed and fuses
the add: one read and one write of the weight, no noise buffer. Counter j
gives four words, two Box-Muller pairs, and each pair both its branches:
elements 4j and 4j + 1 are the cos and sin of words (0, 1), elements 4j + 2
and 4j + 3 those of words (2, 3); the cos branch is the TPU kernel's
transform. Same seed -> same z, so ``+eps, -2eps, +eps`` restores the
weight to about one rounding and ``+-eps`` is an exact antithetic pair.

The noise differs bitwise from the TPU's PRNG (a documented deviation; MeZO
needs i.i.d. N(0, 1) only). ``perturb_ref`` and ``perturb_inplace_ref`` are
the plain PyTorch versions: the same Philox in int64 tensor ops, on whatever
device the tensor lies, and what a CPU tensor takes. The out-of-place form
gives the in-place form's bits for the same seed. The MeZO path runs only
the in-place form; the out-of-place one is the JAX package's public op.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))  # the kernel's 2 pi
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ELEMENTS_PER_COUNTER = 4  # the kernel's kPerCounter

Words = Tuple[torch.Tensor, torch.Tensor]


# -- plain version -----------------------------------------------------------

def _mulhilo(m: int, c: torch.Tensor) -> Words:
    """(hi, lo) 32-bit halves of ``m * c`` for uint32 values held in int64.
    A signed 64-bit product of two uint32 would overflow, so both factors
    split into 16-bit limbs; every partial sum stays below 2^34."""
    mh, ml = m >> 16, m & 0xFFFF
    ch, cl = c >> 16, c & 0xFFFF
    mid = mh * cl + ml * ch
    t = ml * cl + ((mid & 0xFFFF) << 16)
    return mh * ch + (mid >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter: Tuple[torch.Tensor, ...], key: Tuple[int, int]):
    """Random123's ``philox4x32_R(10, counter, key)`` on int64 tensors holding
    uint32 values. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_stream_ref(m: int, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """The four words of counters 0..m-1: Philox of counter (lo(j), hi(j),
    0, 0), key (lo(seed), hi(seed)) -- the kernel's raw stream."""
    j = torch.arange(m, dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    return philox4x32_10((j & _MASK32, j >> 32, zero, zero),
                         (seed & _MASK32, (seed >> 32) & _MASK32))


def box_muller(w0: torch.Tensor, w1: torch.Tensor) -> Words:
    """Both branches of Box-Muller from two 32-bit words (the TPU kernel's
    transform, perturb.py:61-68, is the cos branch): 24 bits each, u1
    clamped at 1e-7, r = sqrt(-2 ln u1), theta = 2 pi u2; float32 results
    ``(r cos theta, r sin theta)``, rounded where the kernel rounds.

    On the card the math is float32 through the card's own log, sqrt, cos
    and sin, those the kernel calls, so the plain version gives the kernel's
    z bit for bit. On the CPU it runs in float64 and rounds to float32 at the
    same points (u1, theta; log u1, each of cos and sin theta, once each and
    correctly in practice; the square root; the products): square root and
    products come out as float32 arithmetic would give them, and log, cos
    and sin never go through the CPU's float32 vector math, so no code path,
    thread or process state moves the result."""
    f32, f64 = torch.float32, torch.float64
    if w0.device.type == "cuda":
        u1 = torch.clamp_min((w0 >> 8).to(f32) * 2.0 ** -24, 1e-7)
        theta = (w1 >> 8).to(f32) * 2.0 ** -24 * _TWO_PI_F32
        r = torch.sqrt(-2.0 * torch.log(u1))
        return r * torch.cos(theta), r * torch.sin(theta)
    u1 = torch.clamp_min((w0 >> 8).to(f64) * 2.0 ** -24, 1e-7).to(f32)
    theta = ((w1 >> 8).to(f64) * 2.0 ** -24 * _TWO_PI_F32).to(f32).to(f64)
    r = torch.sqrt(-2.0 * torch.log(u1.to(f64)).to(f32).to(f64)).to(f32).to(f64)
    return ((r * torch.cos(theta).to(f32).to(f64)).to(f32),
            (r * torch.sin(theta).to(f32).to(f64)).to(f32))


def words_to_normal(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's transform: the cos branch of ``box_muller``."""
    return box_muller(w0, w1)[0]


def normals_ref(n: int, seed: int, device) -> torch.Tensor:
    """z of elements 0..n-1 as the kernel draws them: counter j's words
    (0, 1) give elements 4j, 4j + 1 (cos, sin), its words (2, 3) elements
    4j + 2, 4j + 3."""
    w0, w1, w2, w3 = philox_stream_ref(-(-n // ELEMENTS_PER_COUNTER), seed, device)
    return torch.stack((*box_muller(w0, w1), *box_muller(w2, w3)), 1).reshape(-1)[:n]


def perturb_ref(w: torch.Tensor, seed: int, scale: float,
                words: Optional[Words] = None) -> torch.Tensor:
    """Plain version of the out-of-place kernel: a new tensor, ``w`` is not
    touched. ``words`` replaces the stream by one word pair per element (any
    shape that broadcasts over the flat tensor) through the TPU kernel's
    transform; only tests use it."""
    _check(w, seed)
    z = normals_ref(w.numel(), seed, w.device) if words is None else words_to_normal(*words)
    out = w.reshape(-1).to(torch.float32) + z * float(scale)
    return out.to(w.dtype).view(w.shape)


def perturb_inplace_ref(w: torch.Tensor, seed: int, scale: float,
                        words: Optional[Words] = None) -> torch.Tensor:
    """Plain version of the in-place kernel."""
    w.copy_(perturb_ref(w, seed, scale, words))
    return w


# -- the kernel --------------------------------------------------------------

def _check(w: torch.Tensor, seed: int) -> None:
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(w).__name__}")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"perturb_inplace takes float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("perturb_inplace needs a contiguous tensor")
    if w.numel() == 0:
        raise ValueError("perturb_inplace got an empty tensor")
    if not 0 <= int(seed) <= 2 ** 64 - 1:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a loaded ``csrc/perturb.cu``."""
    lib.ecoflap_perturb_inplace.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_float, ctypes.c_void_p]
    lib.ecoflap_perturb_inplace.restype = ctypes.c_int
    lib.ecoflap_perturb.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_float, ctypes.c_void_p]
    lib.ecoflap_perturb.restype = ctypes.c_int
    lib.ecoflap_philox_words.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
    lib.ecoflap_philox_words.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ecoflap_tpu_torch.ops.build import load

    return bind(load("perturb"))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def perturb_inplace(w: torch.Tensor, seed: int, scale: float) -> torch.Tensor:
    """``w += scale * z(seed)`` in place, on any contiguous float32 or
    bfloat16 tensor. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    _check(w, seed)
    if w.device.type == "cpu":
        return perturb_inplace_ref(w, seed, scale)
    if w.device.type != "cuda":
        raise ValueError(f"perturb_inplace: unsupported device {w.device}")
    lib = _lib()
    with torch.cuda.device(w.device):
        rc = lib.ecoflap_perturb_inplace(
            ctypes.c_void_p(w.data_ptr()), _DTYPE_CODE[w.dtype],
            ctypes.c_uint64(w.numel()), ctypes.c_uint64(int(seed)),
            ctypes.c_float(float(scale)), ctypes.c_void_p(_stream(w.device)))
    if rc != 0:
        raise RuntimeError(f"perturb kernel launch failed: cudaError_t {rc}")
    perturb_inplace.launches += 1
    return w


perturb_inplace.launches = 0


def _empty_in_phase(w: torch.Tensor) -> torch.Tensor:
    """An empty tensor like ``w`` that starts at ``w``'s distance from a
    16-byte boundary, so the kernel reads ``w`` and writes it by the same
    16-byte vectors (``w`` may be a view that starts anywhere)."""
    off = w.data_ptr() % 16 // w.element_size()
    if off == 0:
        return torch.empty_like(w)  # the allocator's blocks are 512-byte aligned
    buf = torch.empty(w.numel() + off, dtype=w.dtype, device=w.device)
    return buf[off:].view(w.shape)


def perturb(w: torch.Tensor, seed: int, scale: float) -> torch.Tensor:
    """``w + scale * z(seed)`` as a new tensor, on a contiguous 2-D float32 or
    bfloat16 weight of any shape (``ecoflap_tpu/ops/perturb.py:perturb``).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    _check(w, seed)
    if w.ndim != 2:
        raise ValueError(f"perturb takes a 2-D weight, got shape {tuple(w.shape)}")
    if w.device.type == "cpu":
        return perturb_ref(w, seed, scale)
    if w.device.type != "cuda":
        raise ValueError(f"perturb: unsupported device {w.device}")
    out = _empty_in_phase(w)
    with torch.cuda.device(w.device):
        rc = _lib().ecoflap_perturb(
            ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            _DTYPE_CODE[w.dtype], ctypes.c_uint64(w.numel()),
            ctypes.c_uint64(int(seed)), ctypes.c_float(float(scale)),
            ctypes.c_void_p(_stream(w.device)))
    if rc != 0:
        raise RuntimeError(f"perturb kernel launch failed: cudaError_t {rc}")
    perturb.launches += 1
    return out


perturb.launches = 0


def perturb_block_inplace(leaf: torch.Tensor, idx: int, seed: int,
                          scale: float) -> torch.Tensor:
    """``leaf[idx] += scale * z`` on a stacked ``(L, r, c)`` leaf; the other
    blocks are not touched."""
    perturb_inplace(leaf[idx], seed, scale)
    return leaf


def philox_stream_cuda(m: int, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """The kernel's four words of counters 0..m-1, read back from the card
    (a check of the plain version, not a step of the pruning path)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("philox_stream_cuda runs on a CUDA device")
    out = torch.empty(4 * m, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _lib().ecoflap_philox_words(
            ctypes.c_void_p(out.data_ptr()), ctypes.c_uint64(m),
            ctypes.c_uint64(int(seed)), ctypes.c_void_p(_stream(device)))
    if rc != 0:
        raise RuntimeError(f"philox words kernel launch failed: cudaError_t {rc}")
    words = out.to(torch.int64) & _MASK32
    return tuple(words[k::4] for k in range(4))
