"""The Gaussian stream of ECoFLaP's zeroth-order (MeZO) coarse stage, and
the perturbed weights W +- eps z it scores with.

Reference semantics (LAVIS layer_single_base_pruner.py:488-561, one noise
draw): a target's score sums, over the coarse microbatches, |L(W + eps z) -
L(W - eps z)| / (2 eps), where L is the microbatch's mean loss and z is a
fresh draw for each (target, microbatch). W +- eps z is formed in float32
and rounded once to the weight's dtype.

z is the configuration's stated stream, so both sides draw the same one:
Philox4x32-10 (Random123) keyed by a 64-bit seed that ``SeedSequence([run
seed, target index, microbatch, draw])`` gives; counter j (low word j, high
word j >> 32, then two zero words) yields four words, and elements 4j, 4j+1
are the cos and sin branches of Box-Muller on words (0, 1), elements 4j+2,
4j+3 on words (2, 3): 24 bits each, u1 clamped at 1e-7, float32 math.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def kernel_seed(seed: int, target: int, batch: int, draw: int = 0) -> int:
    words = np.random.SeedSequence([seed, target, batch, draw]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """32-bit halves of m * c for uint32 values held in int64, by 16-bit
    limbs so that no partial product overflows."""
    mh, ml = m >> 16, m & 0xFFFF
    ch, cl = c >> 16, c & 0xFFFF
    mid = mh * cl + ml * ch
    t = ml * cl + ((mid & 0xFFFF) << 16)
    return mh * ch + (mid >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(w0, w1):
    f32, f64 = torch.float32, torch.float64
    if w0.device.type == "cuda":
        u1 = torch.clamp_min((w0 >> 8).to(f32) * 2.0 ** -24, 1e-7)
        theta = (w1 >> 8).to(f32) * 2.0 ** -24 * _TWO_PI_F32
        r = torch.sqrt(-2.0 * torch.log(u1))
        return r * torch.cos(theta), r * torch.sin(theta)
    # the CPU: float64 math rounded to float32 where the card rounds
    u1 = torch.clamp_min((w0 >> 8).to(f64) * 2.0 ** -24, 1e-7).to(f32)
    theta = ((w1 >> 8).to(f64) * 2.0 ** -24 * _TWO_PI_F32).to(f32).to(f64)
    r = torch.sqrt(-2.0 * torch.log(u1.to(f64)).to(f32).to(f64)).to(f32).to(f64)
    return ((r * torch.cos(theta).to(f32).to(f64)).to(f32),
            (r * torch.sin(theta).to(f32).to(f64)).to(f32))


def normals(n: int, seed: int, device) -> torch.Tensor:
    """The first n elements of the stream keyed by ``seed``, float32."""
    m = -(-n // 4)
    j = torch.arange(m, dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    w0, w1, w2, w3 = philox4x32_10(j & _MASK32, j >> 32, zero, zero,
                                   seed & _MASK32, (seed >> 32) & _MASK32)
    return torch.stack((*_box_muller(w0, w1), *_box_muller(w2, w3)), 1).reshape(-1)[:n]


def perturbed(w: torch.Tensor, seed: int, scale: float) -> torch.Tensor:
    """w + scale z in float32, rounded once to w's dtype."""
    z = normals(w.numel(), seed, w.device).reshape(w.shape)
    return (w.to(torch.float32) + z * scale).to(w.dtype)

