"""LFM2-MoE configurations: build the program's model at a configuration's
sizes, and make a mix's calibration windows from the seed. The program is
imported inside the functions only."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def build(cfg: Dict, device, dtype):
    """(model with uninitialised storage, adapter)."""
    from ecoflap_tpu_torch.models import lfm2_moe

    model = lfm2_moe.build_model(lfm2_moe.Lfm2MoeConfig.from_dict(cfg), device=device,
                                 dtype=dtype, seed=None)
    return model, lfm2_moe.make_adapter(model)


def buffer_list(model: torch.nn.Module, dtype) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """The buffers a seed draws (each layer's ``expert_bias``), as
    ``weights.make`` takes them: drawn in the model's dtype, held in the
    buffer's."""
    return [(n, tuple(b.shape), dtype) for n, b in model.named_buffers()
            if n.endswith("expert_bias")]


@torch.no_grad()
def load_buffers(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    for n, b in model.named_buffers():
        if n in weights:
            b.copy_(weights[n])


def calibration(cfg: Dict, mix: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{input_ids (num_samples, seqlen)} on the card: the prune CLI's
    synthetic branch, one stream of ids uniform in [2, vocabulary) and
    windows at random starts, both from the seed."""
    from ecoflap_tpu_torch.data import calibration as cal

    n, seq = mix["num_samples"], mix["seqlen"]
    stream = cal.synthetic_token_stream(n, seq, cfg["vocab_size"], seed)
    batch = cal.build_lm_calibration_batch(stream, n, seq, seed)
    return {"input_ids": batch["input_ids"].to(device)}
