"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def exact_float32_matmuls() -> None:
    """The JAX package's float32 parity holds only without TF32: matmuls and
    convolutions on the card would otherwise keep ~10 mantissa bits. Set once,
    at an entry point."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a wall-clock reading after it is the
    device's time); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weight_dtype(flag: str, model_scale: str) -> torch.dtype:
    """The CLIs' ``--dtype``: as asked, or for ``auto`` bf16 at small and
    full scale, as the reference runs its models, and float32 at test size."""
    if flag != "auto":
        return torch.bfloat16 if flag == "bfloat16" else torch.float32
    return torch.bfloat16 if model_scale in ("full", "small") else torch.float32
