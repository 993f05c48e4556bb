"""Seeded weights and inputs, made on the card in a few large calls.

A configuration's ``init`` lists rules ``[regex, kind, value]``; the first
whose regex matches a parameter's name (``re.search``) sets it: ``normal``
draws N(0, value^2), ``one_plus_normal`` 1 + N(0, value^2) (a norm's
scale), ``const`` fills ``value``. Every normal draw of a model
comes from one ``torch.randn`` call on the card, in the dtype the model is
served in; each parameter is a view into that one buffer, scaled in place.
The same seed gives the same weights, whatever process makes them, so the
program and the reference get the same dict.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one purpose (``stream``) of one run seed: the run's
    weights, its calibration data and its images draw apart."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)


def _rule(name: str, rules: Sequence[Sequence]) -> Tuple[str, float]:
    for pattern, kind, value in rules:
        if re.search(pattern, name):
            return kind, float(value)
    raise KeyError(f"no init rule matches parameter {name!r}")


def make(params: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]],
         rules: Sequence[Sequence], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape, dtype) triples. Parameters of the
    model's main dtype share one buffer; one of any other dtype (a float32
    logit scale) takes a constant."""
    params = list(params)
    kinds = {n: _rule(n, rules) for n, _, _ in params}
    main = max({d for _, _, d in params}, key=lambda d: sum(
        _numel(s) for _, s, dd in params if dd == d))
    drawn = ("normal", "one_plus_normal")
    normal = [(n, s) for n, s, d in params if d == main and kinds[n][0] in drawn]
    total = sum(_numel(s) for _, s in normal)
    buf = torch.randn(total, generator=generator(seed, device, 0), device=device,
                      dtype=main)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for n, s in normal:
        k = _numel(s)
        out[n] = buf[off:off + k].view(s).mul_(kinds[n][1])
        if kinds[n][0] == "one_plus_normal":
            out[n].add_(1.0)
        off += k
    for n, s, d in params:
        if n not in out:
            kind, value = kinds[n]
            if kind != "const":
                raise ValueError(f"{n}: only the model's main dtype is drawn; {kind!r} "
                                 f"asked of a {d} parameter")
            out[n] = torch.full(s, value, device=device, dtype=d)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def param_list(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    return [(n, tuple(p.shape), p.dtype) for n, p in model.named_parameters()]


@torch.no_grad()
def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's own parameters; every parameter
    must be given."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(weights))
    if missing:
        raise KeyError(f"no weights for {missing[:3]} ({len(missing)} in all)")
    for n, p in own.items():
        p.copy_(weights[n])


@torch.no_grad()
def magnitude_prune_(weights: Dict[str, torch.Tensor], names: Iterable[str],
                     ratio: float) -> None:
    """Zero, in place, the ``ratio`` share of each named weight with the
    smallest magnitudes (entries tied at the threshold go too)."""
    for n in names:
        w = weights[n]
        k = int(w.numel() * ratio)
        if k < 1:
            continue
        mag = w.abs().to(torch.float32)
        w.masked_fill_(mag <= torch.kthvalue(mag.reshape(-1), k).values, 0)
