"""BLIP-1 checkpoints in the port: a model's ``export_state_dict`` is what
the JAX ``export_blip1`` writes for its head (keys, float32 values), and
``load_into`` reads a UPop ``.pth`` with ``convert_blip1``'s
``strict=False`` semantics, NLVR from a base checkpoint included (the
single-stream cross-attention fills both twins, the merge layers it lacks
are zero). Values must be equal; losses after loading within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.upop import build_batch
from ecoflap_tpu_torch.models import blip1 as tblip1
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, load_into
from tests.torch_parity import BLIP1_HEADS, BLIP1_JAX, blip1_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
KINDS = sorted(BLIP1_JAX)


def np_state(sd):
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_export_equals_export_blip1(kind):
    cfg, params, model = blip1_pair(kind, seed=5)
    want = jck.export_blip1(params, cfg, kind)
    got = export_state_dict(model)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_load_reads_convert_blip1s_checkpoint(kind):
    """A ``.pth`` of the JAX export loads into a fresh model, which then
    computes the JAX loss of ``convert_blip1``'s params."""
    cfg, params, _ = blip1_pair(kind, seed=6)
    state = jck.export_blip1(params, cfg, kind)
    model = tblip1.build_model(tblip1.tiny_config(), kind, device="cpu", seed=1)
    assert load_into(model, {k: torch.from_numpy(np.array(v)) for k, v in state.items()}) == 0
    init = getattr(jblip1, BLIP1_JAX[kind][0])(cfg, jax.random.PRNGKey(0))
    conv = jck.convert_blip1(state, cfg, kind, init)
    head = {v: k for k, v in BLIP1_HEADS.items()}[kind]
    batch = build_batch(head, cfg, 4)
    jb = {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
          for k, v in batch.items()}
    want = np.asarray(getattr(jblip1, BLIP1_JAX[kind][1])(cfg, conv, jb))
    with torch.no_grad():
        got = model.per_sample_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_nlvr_loads_from_a_base_checkpoint():
    """A retrieval (base) checkpoint's ``text_encoder`` has one cross stream
    and no merge layer: both twins take it, every merge layer is zero, and
    the loss equals the JAX loss of ``convert_blip1(..., "blip_nlvr")``."""
    cfg, params, _ = blip1_pair("blip_retrieval", seed=7)
    base = jck.export_blip1(params, cfg, "blip_retrieval")
    nlvr_init = jblip1.init_nlvr_params(cfg, jax.random.PRNGKey(8))
    for name, sub in (("cls_head.0", "dense"), ("cls_head.2", "out")):
        base[f"{name}.weight"] = np.asarray(nlvr_init["cls_head"][sub]["kernel"]).T
        base[f"{name}.bias"] = np.asarray(nlvr_init["cls_head"][sub]["bias"])
    assert not any(".self0." in k or "merge_layer" in k for k in base)
    model = tblip1.build_model(tblip1.tiny_config(), "blip_nlvr", device="cpu", seed=3)
    ignored = load_into(model, {k: torch.from_numpy(np.array(v)) for k, v in base.items()})
    assert ignored > 0  # vision_proj, text_proj, itm_head and the single-stream keys
    for layer in model.text_encoder.encoder.layer:
        cp = layer.crossattention
        assert torch.equal(cp.self0.query.weight, cp.self1.query.weight)
        assert torch.equal(cp.output.dense0.weight, cp.output.dense1.weight)
        assert not cp.output.merge_layer.weight.any()
    conv = jck.convert_blip1(base, cfg, "blip_nlvr", nlvr_init)
    batch = build_batch("nlvr", cfg, 4)
    jb = {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
          for k, v in batch.items()}
    want = np.asarray(jblip1.nlvr_loss(cfg, conv, jb))
    with torch.no_grad():
        got = model.per_sample_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_missing_tower_key_raises_and_missing_heads_keep_their_values():
    cfg, params, _ = blip1_pair("blip_retrieval", seed=9)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in jck.export_blip1(params, cfg, "blip_retrieval").items()}
    model = tblip1.build_model(tblip1.tiny_config(), "blip_retrieval", device="cpu", seed=2)
    before = model.itm_head.weight.clone()
    partial = {k: v for k, v in state.items() if not k.startswith("itm_head.")}
    load_into(model, partial)
    assert torch.equal(model.itm_head.weight, before)
    broken = dict(state)
    del broken["text_encoder.encoder.layer.1.intermediate.dense.weight"]
    with pytest.raises(KeyError, match="intermediate"):
        load_into(model, broken)
