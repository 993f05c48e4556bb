"""The port's UPop launcher (``ecoflap_tpu_torch/cli/upop.py``) against the
flow of the JAX launchers (``scripts/upop/_shared.py:run`` with each
script's ``batch_builder`` and ``stack_names``), built here from the JAX
modules, for the four heads: both start from one ``--ckpt`` (a tiny BLIP-1
whose kernels are 10x the init, exported by ``export_blip1``), prune with
the same MeZO noise (injected) at eps 0.2 (the reference's 1e-3 moves the
tiny model's loss by a few float32 ulps), fine-tune 2 masked AdamW steps
and write the pruned model.

Bounds: the launchers' batches are equal; ``sparsity`` within 1e-6 and
``groups`` equal; the pruned ``.pth`` has the same keys and zero patterns;
the fine-tune losses and the fine-tuned values within 1e-5 (NLVR: the JAX
fine-tune also steps its 0/1 ``merge_on`` flags, a parameter leaf there and
a constant in the port, which moves the last loss by less than that). The
fine-tune moves the values by only some 2e-5, so its update (the fine-tuned
values less each side's pruned ones) is held on its own: within 1e-3 of
the JAX update's L2 norm plus one float32 ulp of each entry for each step
(each side rounds each step's new value to within half an ulp), tensor by
tensor. A fine-tune that does nothing, or one without the weight decay,
misses that bound on every linear.

NLVR's averaged layers keep a ``merge_layer`` that no output reads and that
a checkpoint leaves out, so it loads as zeros. The JAX serial MeZO cycle
restores a weight only up to a rounding (its z * scale products round
apart), which leaves those zeros a few 1e-8 away from 0, and Wanda then
keeps half of them; the port's cycle with the injected z restores them to 0
exactly. So for NLVR ``sparsity`` is compared over the other targets, and
the port's exceeds the JAX one by at most those layers' share."""

import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.pruning.pruners import WandaPruner
from ecoflap_tpu.runners.finetune import finetune
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli import upop
from ecoflap_tpu_torch.runners import finetune as tft
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict
from tests.torch_parity import BLIP1_HEADS, BLIP1_JAX, blip1_pair, jax_noise  # noqa: F401
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"caption": "ecoflap_caption", "vqa": "ecoflap_vqa", "nlvr": "ecoflap_nlvr",
           "retrieval": "ecoflap_retrieval_flickr"}
N, STEPS, EPS, TOL, UPDATE_REL = 16, 2, 0.2, 1e-5, 1e-3


def script(head, monkeypatch):
    """A JAX launcher as a module (its ``batch_builder`` and ``stack_names``);
    it imports ``_shared`` from its own directory."""
    folder = os.path.join(ROOT, "scripts", "upop")
    monkeypatch.syspath_prepend(folder)
    path = os.path.join(folder, SCRIPTS[head] + ".py")
    spec = importlib.util.spec_from_file_location(f"upop_{head}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_flow(head, ckpt, monkeypatch):
    """``_shared.run``'s flow, float32 (``--model_scale tiny``)."""
    mod, kind = script(head, monkeypatch), BLIP1_HEADS[head]
    init_name, _, adapter_name = BLIP1_JAX[kind]
    cfg = jblip1.tiny_config()
    params = getattr(jblip1, init_name)(cfg, jax.random.PRNGKey(0))
    params = jck.convert_blip1(jck.load_torch_checkpoint(ckpt), cfg, kind, params)
    adapter = getattr(jblip1, adapter_name)(cfg, params)
    batch = mod.batch_builder(cfg, N)
    specs = {name: f"{depth}-0.5-1.0-1.0" for name, depth in mod.stack_names(cfg)}
    pruner = WandaPruner(adapter, batch, num_microbatches=max(1, N // 8), stack_specs=specs,
                         sparsity_ratio_granularity="block", max_sparsity_per_layer=0.6,
                         score_method="MEZO-GradOnly_sum", num_data_first_stage=min(32, N),
                         noise_eps=EPS, verbose=False)
    params, sd = pruner.prune()
    out = {"sparsity": pruner.check_sparsity(), "groups": len(sd or {})}
    pruned = jck.export_blip1(params, cfg, kind)
    params, losses = finetune(adapter.loss_fn, params, [batch] * STEPS,
                              optimizer=optax.adamw(1e-5, weight_decay=0.05))
    out["ft_loss_first"], out["ft_loss_last"] = losses[0], losses[-1]
    return out, batch, pruned, jck.export_blip1(params, cfg, kind)


@pytest.mark.parametrize("head", ["caption", "vqa"])
def test_upop_launcher_matches_the_jax_flow(tmp_path, monkeypatch, head):
    check_head(tmp_path, monkeypatch, head)


def check_head(tmp_path, monkeypatch, head):
    """One head's comparison (the NLVR and retrieval heads run it from
    tests/test_torch_upop_cli_twin_itm.py, so that each file takes well
    under a minute)."""
    kind = BLIP1_HEADS[head]
    cfg, params, _ = blip1_pair(kind, seed=11, kernel_scale=10.0)
    ckpt = str(tmp_path / "start.pth")
    jck.save_torch_checkpoint(jck.export_blip1(params, cfg, kind), ckpt)
    want, jbatch, jpruned, jtuned = jax_flow(head, ckpt, monkeypatch)

    # the port's batch is the launcher's
    for k, v in upop.build_batch(head, cfg, N).items():
        np.testing.assert_array_equal(v, np.asarray(jbatch[k]), err_msg=k)

    # the port's pruned model as the fine-tune starts, under the reference names
    pruned, make_masks = {}, tft.make_sparsity_masks

    def recording_masks(model):
        pruned.update(export_state_dict(model))
        return make_masks(model)

    monkeypatch.setattr(tft, "make_sparsity_masks", recording_masks)
    out = str(tmp_path / "pruned.pth")
    got = upop.main(["--head", head, "--device", "cpu", "--ckpt", ckpt, "--num_samples",
                     str(N), "--finetune_steps", str(STEPS), "--save_pruned", out,
                     "--noise_eps", str(EPS)], noise=jax_noise(jax.random.PRNGKey(0)))
    print(head, {k: got[k] for k in want}, want)
    model, targets = got["model"], got["adapter"].targets()
    dead = {t.name for t in targets
            if t.name.endswith("merge_layer.weight") and not t.stack.blocks(model)[
                t.block_index].merge_on}
    total = sum(t.numel(model) for t in targets)
    dead_share = sum(t.numel(model) for t in targets if t.name in dead) / total
    gap = got["sparsity"] - float(want["sparsity"])
    assert -1e-6 <= gap <= dead_share + 1e-6, (gap, dead_share)
    assert bool(dead) == (head == "nlvr")
    live = [t for t in targets if t.name not in dead]
    jzeros = sum(int((np.asarray(jpruned[t.name]) == 0).sum()) for t in live)
    tzeros = sum(int((t.weight(model) == 0).sum()) for t in live)
    assert tzeros == jzeros
    assert got["groups"] == want["groups"]
    assert got["pruned_checkpoint"] == out
    for k in ("ft_loss_first", "ft_loss_last"):
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), k
    tuned = torch.load(out, weights_only=True)
    assert sorted(tuned) == sorted(jtuned)
    names = {t.name for t in got["adapter"].targets()}
    for k, v in jpruned.items():
        if k in names:  # a pruned entry stays 0 through the fine-tune
            np.testing.assert_array_equal(tuned[k].numpy() == 0, np.asarray(v) == 0,
                                          err_msg=k)
    for k, v in jtuned.items():
        np.testing.assert_allclose(tuned[k].numpy(), np.asarray(v), rtol=TOL, atol=TOL,
                                   err_msg=k)
        # the fine-tune's update, each side's own, within UPDATE_REL of the
        # JAX one's norm plus a float32 ulp of each entry for each step
        d_port = tuned[k].double() - pruned[k].double()
        d_jax = torch.from_numpy(np.asarray(v, np.float64) - np.asarray(jpruned[k], np.float64))
        mag = pruned[k].abs()
        ulp = float((torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).norm())
        err, norm = float((d_port - d_jax).norm()), float(d_jax.norm())
        assert err <= UPDATE_REL * norm + STEPS * ulp, (k, err, norm, ulp)
