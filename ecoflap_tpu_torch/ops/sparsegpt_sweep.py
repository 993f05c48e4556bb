"""SparseGPT's in-block column sweep as one CUDA kernel a column block
(``csrc/sparsegpt_sweep.cu``).

``sparsegpt_sweep`` runs the sequential OBS sweep of one column block of K
same-shape weights in place: the block's columns of the weight become Q1
(each entry 0 where pruned, else the weight as the sweep has updated it),
and the returned (K, rows, B) tensor is Err1, which the caller folds into
the columns after the block with one ``torch.bmm``. It computes what
``pruning/sparsegpt.py:_sweep_block``, its plain version, computes, in the
same order and roundings, so on the card the two give the same bits. It
takes a CUDA tensor only; the CPU takes the plain version in the pruning
code. The kernel replaces no TPU kernel (the JAX package's sweep is an XLA
``fori_loop``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

MAX_BLOCK = 128  # the kernel's kMaxBlock: 4 columns in each of a warp's 32 lanes
MAX_M = 32  # the largest n:m group the kernel chooses a mask in
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def check(w1: torch.Tensor, hinv1: torch.Tensor, mask1: Optional[torch.Tensor],
          prune_n: int, prune_m: int) -> None:
    """Raise on what the kernel does not take: ``w1`` a (K, rows, B) float32
    or float64 view with unit column stride, 1 <= B <= 128; ``hinv1`` (K,
    B, B) of its dtype and device, unit column stride; ``mask1`` a
    contiguous (K, rows, B) bool tensor when ``prune_n`` is 0 and None
    otherwise; an n:m group of at most 32 columns that divides B."""
    for name, t in (("w1", w1), ("hinv1", hinv1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sparsegpt_sweep: {name} is not a tensor")
    if w1.dtype not in _DTYPE_CODE:
        raise TypeError(f"sparsegpt_sweep takes float32 or float64, got {w1.dtype}")
    if hinv1.dtype != w1.dtype:
        raise TypeError(f"sparsegpt_sweep: hinv1 is {hinv1.dtype}, w1 {w1.dtype}")
    if w1.ndim != 3 or min(w1.shape) < 1:
        raise ValueError(f"sparsegpt_sweep: w1 must be (K, rows, B), got {tuple(w1.shape)}")
    k, rows, bsz = w1.shape
    if bsz > MAX_BLOCK:
        raise ValueError(f"sparsegpt_sweep: a block of {bsz} columns, at most {MAX_BLOCK}")
    if k > 65535:
        raise ValueError(f"sparsegpt_sweep: {k} lanes, at most 65535")
    if tuple(hinv1.shape) != (k, bsz, bsz):
        raise ValueError(f"sparsegpt_sweep: hinv1 must be {(k, bsz, bsz)}, "
                         f"got {tuple(hinv1.shape)}")
    if w1.stride(-1) != 1 or hinv1.stride(-1) != 1 or min(w1.stride() + hinv1.stride()) < 0:
        raise ValueError("sparsegpt_sweep: w1 and hinv1 need unit column stride, "
                         f"got {w1.stride()} and {hinv1.stride()}")
    if hinv1.device != w1.device:
        raise ValueError(f"sparsegpt_sweep: hinv1 on {hinv1.device}, w1 on {w1.device}")
    if prune_n < 0:
        raise ValueError(f"sparsegpt_sweep: prune_n {prune_n} < 0")
    if prune_n == 0:
        if mask1 is None or mask1.dtype != torch.bool or tuple(mask1.shape) != tuple(w1.shape):
            raise ValueError("sparsegpt_sweep: without n:m, mask1 must be a bool tensor "
                             f"of w1's shape {tuple(w1.shape)}")
        if not mask1.is_contiguous() or mask1.device != w1.device:
            raise ValueError("sparsegpt_sweep: mask1 must be contiguous, on w1's device")
    else:
        if mask1 is not None:
            raise ValueError("sparsegpt_sweep: n:m chooses its own mask; pass mask1=None")
        if not 1 <= prune_m <= MAX_M or bsz % prune_m:
            raise ValueError(f"sparsegpt_sweep: n:m groups of {prune_m} columns; the "
                             f"kernel takes at most {MAX_M} that divide the block's {bsz}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry's argument types on a loaded ``csrc/sparsegpt_sweep.cu``."""
    i64, ptr, c_int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.ecoflap_sparsegpt_sweep.argtypes = [
        ptr, c_int, c_int, c_int, c_int, i64, i64, ptr, i64, i64, ptr, ptr, c_int, c_int, ptr]
    lib.ecoflap_sparsegpt_sweep.restype = c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ecoflap_tpu_torch.ops.build import load

    return bind(load("sparsegpt_sweep"))


def sparsegpt_sweep(w1: torch.Tensor, hinv1: torch.Tensor, mask1: Optional[torch.Tensor],
                    prune_n: int = 0, prune_m: int = 0) -> torch.Tensor:
    """Sweep one column block in place (``w1`` becomes Q1) and return Err1,
    (K, rows, B) contiguous; one kernel launch on ``w1``'s current stream.
    ``mask1`` (True = prune) is None with n:m, which the kernel chooses per
    ``prune_m``-column group. Raises on a tensor off the card."""
    check(w1, hinv1, mask1, prune_n, prune_m)
    if w1.device.type != "cuda":
        raise ValueError(f"sparsegpt_sweep runs on a CUDA device, got {w1.device}")
    k, rows, bsz = w1.shape
    err1 = torch.empty((k, rows, bsz), dtype=w1.dtype, device=w1.device)
    with torch.cuda.device(w1.device):
        rc = _lib().ecoflap_sparsegpt_sweep(
            ctypes.c_void_p(w1.data_ptr()), _DTYPE_CODE[w1.dtype], k, rows, bsz,
            w1.stride(0), w1.stride(1), ctypes.c_void_p(hinv1.data_ptr()),
            hinv1.stride(0), hinv1.stride(1),
            ctypes.c_void_p(0 if mask1 is None else mask1.data_ptr()),
            ctypes.c_void_p(err1.data_ptr()), prune_n, prune_m,
            ctypes.c_void_p(torch.cuda.current_stream(w1.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"sparsegpt sweep kernel launch failed: cudaError_t {rc}")
    sparsegpt_sweep.launches += 1
    return err1


sparsegpt_sweep.launches = 0
