"""Masked fine-tuning in the port (``ecoflap_tpu_torch/runners/finetune.py``)
against the JAX package's ``runners/finetune.py``, tiny BLIP-1 captioner in
float32 with half of every linear pruned: the backward's gradients, one
masked AdamW step from the same gradients (the port's ``torch.optim.AdamW``
against optax ``adamw``, lr 1e-5, at the UPop runs' weight decay 0.05 and at
1.0), and three steps of ``finetune`` keeping every pruned entry exactly 0.

Tolerances: gradients 1e-5 relative to each tensor's largest entry, at
least 1e-6 (float32 sums in another order); the step's parameters 1e-6
absolute, and its update (the parameters after the step less those before)
within 1e-3 of the JAX update's L2 norm plus the L2 norm of one float32 ulp
of each entry (each side rounds its new value to within half an ulp: on the
norms' weights of about 1.0 that is some 1e-2 of an update of 1e-5, on the
linears' of about 0.02 some 2e-4), tensor by tensor. A first Adam step
moves each entry by about lr, so the absolute bound alone would pass a step
that does nothing. At weight decay 1.0 the decoupled decay term, lr * wd * |w|,
is some 2% of the update: a step without decay, or with coupled L2 decay
(``torch.optim.Adam``), misses the bound by far."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.runners import finetune as jft
from ecoflap_tpu_torch.cli.upop import build_batch
from ecoflap_tpu_torch.models.convert import jax_to_state_dict, load_jax_params
from ecoflap_tpu_torch.runners import finetune as tft
from tests.torch_parity import blip1_pair, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def pruned_pair(seed=0):
    """The pair with a random half of every linear kernel set to 0."""
    cfg, params, model = blip1_pair("blip_caption", seed=seed)
    rng = np.random.default_rng(seed)

    def prune(path, a):
        if getattr(path[-1], "key", None) != "kernel":
            return a
        return a * jnp.asarray(rng.random(a.shape) < 0.5, a.dtype)

    params = jax.tree_util.tree_map_with_path(prune, params)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def jax_loss(cfg):
    return lambda p, b: jblip1.per_sample_loss(cfg, p, b)


def batches(cfg, n=8):
    b = build_batch("caption", cfg, n)
    jb = {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
          for k, v in b.items()}
    return jb, {k: torch.from_numpy(v) for k, v in b.items()}


def port_layout(tree, cfg, model):
    """A JAX pytree (gradients, parameters) under the port's names, the
    parameters that ``named_parameters`` lists."""
    sd = jax_to_state_dict({k: np.asarray(v) for k, v in flatten_named(tree).items()},
                           model.cfg, model)
    return {n: torch.from_numpy(np.array(sd[n], np.float32))
            for n, _ in model.named_parameters()}


def masked_step_pair(seed, weight_decay):
    """One masked AdamW step at lr 1e-5 on both sides from the same
    gradients (the JAX ones, after holding the port's backward to them).
    Returns (the port's model after it, its masks, the parameters before it
    and the JAX parameters after it, both under the port's names)."""
    cfg, params, model = pruned_pair(seed=seed)
    jb, tb = batches(cfg)
    masks = jft.make_sparsity_masks(params)
    opt = optax.adamw(1e-5, weight_decay=weight_decay)
    grads = jax.grad(lambda p: jnp.mean(jax_loss(cfg)(p, jb)))(params)
    step = jft.make_train_step(jax_loss(cfg), opt, donate=False)
    want, _, _ = step(params, opt.init(params), masks, jb)

    # the port's backward gives the JAX gradients
    tmasks = tft.make_sparsity_masks(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.requires_grad_(True)
    optimizer = tft.adamw(model, weight_decay=weight_decay)
    optimizer.zero_grad()
    model.per_sample_loss(tb).mean().backward()
    jgrads = port_layout(grads, cfg, model)
    for n, p in model.named_parameters():
        g = jgrads[n]
        # a floor for the tensors whose gradient is 0 up to rounding (the
        # attention keys' bias: softmax ignores a shift common to a row)
        scale = max(float(g.abs().max()), 1e-6)
        pg = torch.zeros_like(p) if p.grad is None else p.grad  # unused: vision_proj
        assert float((pg - g).abs().max()) <= 1e-5 * scale, n
        p.grad = g.clone()  # the same gradients on both sides
    tft.masked_update(model, optimizer, tmasks)
    return model, tmasks, before, port_layout(want, cfg, model)


def check_update(model, before, want, n, rel=1e-3):
    """The port's update of parameter ``n`` within ``rel`` of the JAX
    update's L2 norm plus the norm of one ulp of each entry; returns
    (that norm, the bound)."""
    got = dict(model.named_parameters())[n].detach() - before[n]
    ref = want[n] - before[n]
    mag = before[n].abs()
    ulp = float((torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).norm())
    norm = float(ref.norm())
    bound = rel * norm + ulp
    assert float((got - ref).norm()) <= bound, (n, float((got - ref).norm()), norm, ulp)
    return norm, bound


def test_one_masked_step_equals_optax_adamw():
    model, tmasks, before, want = masked_step_pair(seed=1, weight_decay=0.05)
    moved = 0.0
    for n, p in want.items():
        got = dict(model.named_parameters())[n].detach()
        assert float((got - p).abs().max()) <= 1e-6, n
        assert torch.equal(got == 0, p == 0) or not tmasks[n].all(), n
        moved += check_update(model, before, want, n)[0]
    assert moved > 0


def test_one_masked_step_decays_decoupled_as_optax():
    """Weight decay 1.0: the decay term is well above the bound, so the
    update check tells decoupled decay from none and from coupled L2."""
    wd = 1.0
    model, tmasks, before, want = masked_step_pair(seed=3, weight_decay=wd)
    for n in want:
        _, bound = check_update(model, before, want, n)
        decay = float((1e-5 * wd * before[n] * tmasks[n]).norm())
        # the check can see the decay: leaving it out moves the update by
        # more than 10x the bound wherever the tensor holds weights of note
        if float(before[n].abs().max()) > 0.01:
            assert decay > 10 * bound, (n, decay, bound)


def test_pruned_entries_stay_zero_through_three_steps():
    cfg, _, model = pruned_pair(seed=2)
    _, tb = batches(cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, losses = tft.finetune(lambda m, b: m.per_sample_loss(b), model, [tb] * 3)
    assert len(losses) == 3 and all(np.isfinite(losses))
    changed = 0
    for n, p in model.named_parameters():
        zero = before[n] == 0
        assert not p[zero].any(), n  # every pruned entry exactly 0
        changed += int((p[~zero] != before[n][~zero]).sum())
    assert changed > 0
    assert not any(p.requires_grad for p in model.parameters())
