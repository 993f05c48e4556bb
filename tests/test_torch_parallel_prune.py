"""Pruning and masked fine-tuning under the mesh on the CPU, gloo ranks
(tests/torch_dist.py): the tiny LLaMA of the JAX test_parallel.py:92-139
at dp=2,tp=2 (4 ranks) and dp=4,tp=2 (8 ranks) against the port in one
process and against the JAX package's sharded run on its 8-device mesh,
the MeZO noise being the JAX draws in both packages.

One spawn per mesh runs every case (``torch_dist.llama_suite``): MeZO
coarse stage + Wanda, SparseGPT from that dict, a first-order coarse stage +
Wanda, and two masked AdamW steps of the first pruned model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.pruning.pruners import SparseGPTPruner, TwoStagePruner
from ecoflap_tpu_torch.runners.finetune import adamw, finetune
from tests.torch_dist import Ranks
from tests.torch_parity import jax_noise, llama_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(d_model=64, d_ff=128, num_heads=8, num_kv_heads=8)
NUM_MB = 2
KEY = jax.random.PRNGKey(0)  # the JAX pruner's default MeZO key (mezo.py:242)
SPECS = {"model.layers": "2-0.5-1.0-1.0"}
MEZO = dict(stack_specs=SPECS, sparsity_ratio_granularity="block",
            score_method="MEZO-GradOnly_sum", num_data_first_stage=16,
            max_sparsity_per_layer=0.6)
FIRST_ORDER = {**MEZO, "score_method": "GradOnly_sum"}
SGPT = dict(stack_specs=SPECS)
FT = dict(steps=2, lr=1e-2, wd=0.05)
MESHES = [(2, 2), (4, 2)]


def _draws(model):
    """The JAX draws of every (target, microbatch, draw), (out, in)."""
    noise = jax_noise(KEY)
    return {(ti, b, 0): noise(ti, b, 0, tuple(t.weight(model).shape)).numpy()
            for ti, t in enumerate(tllama.make_adapter(model).targets())
            for b in range(NUM_MB)}


@pytest.fixture(scope="module")
def setup():
    cfg, params, model = llama_pair(seed=0, **CFG)
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(16, 12))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return cfg, params, sd, ids, _draws(model)


def _port_model(sd):
    model = tllama.build_model(tllama.tiny_config(**CFG), device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def single(setup, started):
    """The port in one process: the same four runs."""
    _, _, sd, ids, draws = setup
    batch = {"input_ids": torch.from_numpy(ids)}
    out = {}

    def prune(cls, cfg, noise=None):
        model = _port_model(sd)
        p = cls(tllama.make_adapter(model), batch, NUM_MB, noise=noise, verbose=False,
                **cfg)
        with torch.no_grad():
            _, sdict = p.prune()
        return model, {"dict": dict(sdict), "sparsity": p.check_sparsity(),
                       "scores": dict(p.leaf_scores), "state": _state(model)}

    model, out["mezo"] = prune(TwoStagePruner, MEZO,
                               lambda ti, b, n, shape: torch.from_numpy(draws[ti, b, n]))
    _, out["sparsegpt"] = prune(SparseGPTPruner, {**SGPT,
                                                  "sparsity_dict": out["mezo"]["dict"]})
    _, out["first_order"] = prune(TwoStagePruner, FIRST_ORDER)
    _, losses = finetune(lambda m, b: m.per_sample_loss(b["input_ids"]), model,
                         [batch] * FT["steps"],
                         optimizer=adamw(model, FT["lr"], FT["wd"]))
    out["finetune"] = {"losses": losses, "state": _state(model)}
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """Both meshes' ranks, started at once; the references compute in this
    process while they run."""
    _, _, sd, ids, draws = setup
    out = {}
    for dp, tp in MESHES:
        payload = {"cfg": CFG, "sd": sd, "batch": {"input_ids": ids}, "num_mb": NUM_MB,
                   "draws": draws, "mezo": MEZO, "sparsegpt": SGPT,
                   "first_order": FIRST_ORDER, "dp": dp, "tp": tp, **FT}
        out[dp, tp] = Ranks("llama_suite", dp * tp, payload,
                            tmp_path_factory.mktemp(f"suite{dp}{tp}"), timeout=300)
    return out


@pytest.fixture(scope="module")
def all_meshed(started, single, jax_sharded):
    return {m: r.wait() for m, r in started.items()}


@pytest.fixture(params=MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def meshed(request, all_meshed):
    return all_meshed[request.param]


@pytest.fixture(scope="module")
def jax_sharded(setup, started, devices):
    """The JAX package's run of the same prunes (test_parallel.py:92-139):
    params tp-sharded, batch dp-sharded over dp=4,tp=2. The MeZO coarse
    stage + Wanda, SparseGPT from its dict, and the first-order coarse stage
    + Wanda with its per-target sums (``first_order_group_sums`` over the
    same microbatches)."""
    from ecoflap_tpu.parallel.mesh import make_mesh
    from ecoflap_tpu.parallel.sharding import shard_batch, shard_params
    from ecoflap_tpu.pruning.first_order import first_order_group_sums
    from ecoflap_tpu.pruning.pruners import SparseGPTPruner as JSparseGPT
    from ecoflap_tpu.pruning.pruners import WandaPruner

    cfg, params, _, ids, _ = setup
    mesh = make_mesh(tp=2)
    batch = shard_batch({"input_ids": jnp.asarray(ids, jnp.int32)}, mesh)
    out = {}

    def zeros(ad, pruned):
        return {t.name: np.asarray(t.get(pruned)) == 0 for t in ad.targets()}

    with mesh:
        ad = jllama.make_adapter(cfg, shard_params(params, mesh))
        p = WandaPruner(ad, batch, num_microbatches=NUM_MB, verbose=False, **MEZO)
        pruned, jdict = p.prune()
        out["mezo"] = {"dict": {k: float(v) for k, v in jdict.items()},
                       "zeros": zeros(ad, pruned)}
        ad2 = jllama.make_adapter(cfg, shard_params(params, mesh))
        s = JSparseGPT(ad2, batch, num_microbatches=NUM_MB, stack_specs=SPECS,
                       sparsity_dict=jdict, verbose=False)
        spruned, _ = s.prune()
        out["sparsegpt"] = {"zeros": zeros(ad2, spruned),
                            "sparsity": float(s.check_sparsity())}
        ad3 = jllama.make_adapter(cfg, shard_params(params, mesh))
        mbs = [jax.tree_util.tree_map(
            lambda x: x.reshape(NUM_MB, -1, *x.shape[1:])[b], batch) for b in range(NUM_MB)]
        sums = first_order_group_sums(ad3.loss_fn, ad3.params, mbs, ad3.targets(),
                                      "GradOnly",
                                      partition_prefixes=[st.blocks_path for st in ad3.stacks])
        f = WandaPruner(ad3, batch, num_microbatches=NUM_MB, verbose=False, **FIRST_ORDER)
        fpruned, fdict = f.prune()
        out["first_order"] = {"dict": {k: float(v) for k, v in fdict.items()},
                              "zeros": zeros(ad3, fpruned),
                              "scores": {k: float(v) for k, v in sums.items()}}
    return out


def _close_dicts(a, b, tol=1e-4):
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) < tol, (k, a[k], b[k])


def _masks_agree(state, ref, names, share=0.999):
    for k in names:
        agree = np.mean((state[k] == 0) == (ref[k] == 0))
        assert agree > share, (k, agree)


TARGET_NAMES = [f"model.layers.{i}.{ln}.weight" for i in range(2)
                for ln in tllama.LINEAR_NAMES]


def test_mezo_wanda_matches_one_process(meshed, single):
    for r in meshed:
        _close_dicts(r["mezo"]["dict"], single["mezo"]["dict"])
        _masks_agree(r["mezo"]["state"], single["mezo"]["state"], TARGET_NAMES)
        assert abs(r["mezo"]["sparsity"] - single["mezo"]["sparsity"]) < 1e-3


def test_every_rank_holds_the_same_pruned_weights(meshed):
    """All ranks gather identical weights after each run: the same reduced
    statistics give the same masks and sweeps on every tp rank."""
    for run in ("mezo", "sparsegpt", "first_order", "finetune"):
        ref = meshed[0][run]["state"]
        for r in meshed[1:]:
            for k, v in ref.items():
                np.testing.assert_array_equal(r[run]["state"][k], v, err_msg=(run, k))


def _matches_jax(meshed, want, run):
    """Every dict entry within 1e-4, masks agreeing on more than 0.999 of
    each tensor."""
    for r in meshed:
        _close_dicts(r[run]["dict"], want["dict"])
        for k in TARGET_NAMES:
            agree = np.mean((r[run]["state"][k] == 0) == want["zeros"][k])
            assert agree > 0.999, (k, agree)


def test_mezo_wanda_matches_the_jax_sharded_run(meshed, jax_sharded):
    _matches_jax(meshed, jax_sharded["mezo"], "mezo")


def test_first_order_matches_the_jax_sharded_run(meshed, jax_sharded):
    """The streamed first-order coarse stage + Wanda against the JAX run on
    its dp=4,tp=2 mesh; the per-target sums of the dp-summed, tp-gathered
    gradients within the first-order parity bound
    (tests/test_torch_first_order.py)."""
    want = jax_sharded["first_order"]
    _matches_jax(meshed, want, "first_order")
    for r in meshed:
        assert set(r["first_order"]["scores"]) == set(want["scores"])
        for k, v in want["scores"].items():
            np.testing.assert_allclose(r["first_order"]["scores"][k], v, rtol=2e-4,
                                       atol=1e-6, err_msg=k)


def test_sparsegpt_from_the_dict_matches(meshed, single, jax_sharded):
    for r in meshed:
        assert r["sparsegpt"]["dict"] == r["mezo"]["dict"]  # consumed verbatim
        _masks_agree(r["sparsegpt"]["state"], single["sparsegpt"]["state"], TARGET_NAMES)
        for k in TARGET_NAMES:
            np.testing.assert_allclose(r["sparsegpt"]["state"][k],
                                       single["sparsegpt"]["state"][k],
                                       rtol=1e-3, atol=1e-4, err_msg=k)
            agree = np.mean((r["sparsegpt"]["state"][k] == 0)
                            == jax_sharded["sparsegpt"]["zeros"][k])
            assert agree > 0.999, (k, agree)
        assert abs(r["sparsegpt"]["sparsity"] - jax_sharded["sparsegpt"]["sparsity"]) < 2e-3


def test_first_order_matches_one_process(meshed, single):
    """The streamed per-block backward under the mesh: per-microbatch
    gradients summed over dp, |g| taken on the whole gathered gradient."""
    for r in meshed:
        for k, v in single["first_order"]["scores"].items():
            assert abs(r["first_order"]["scores"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
        _close_dicts(r["first_order"]["dict"], single["first_order"]["dict"])
        _masks_agree(r["first_order"]["state"], single["first_order"]["state"],
                     TARGET_NAMES)


def test_masked_finetune_matches_one_process_and_keeps_zeros(meshed, single):
    pruned = single["mezo"]["state"]
    for r in meshed:
        np.testing.assert_allclose(r["finetune"]["losses"], single["finetune"]["losses"],
                                   rtol=0, atol=1e-5)
        for k in TARGET_NAMES:
            w = r["finetune"]["state"][k]
            assert np.all(w[pruned[k] == 0] == 0), k  # pruned entries stay 0
            # Adam divides by sqrt(v): a gradient near 0 whose last bits differ
            # with the reduction order moves its weight by up to ~lr per step
            np.testing.assert_allclose(w, single["finetune"]["state"][k],
                                       rtol=0, atol=1e-4, err_msg=k)
