"""The port's global-mask baselines (``GlobalPruner``: magnitude, |W| |G|
and MeZO scores) against the JAX package's on tiny BLIP-2 and tiny LLaMA,
the same weights and calibration batch.

Tolerances: magnitude masks and pruned values are equal (|W| is exact in
both). |W| |G| importances are held at rtol 1e-4 (float32 gradients whose
reduction order differs: the port streams each stack's backward block by
block, JAX takes one whole-loss gradient), with an absolute floor of 1e-6
of the largest importance for entries whose gradient cancels; masks then
agree except on entries within 1e-3 of the threshold. MeZO scores use the
port's noise hook replaying the JAX draws (tests/torch_parity.py); the scores agree to
rtol 1e-3 (tests/test_torch_mezo.py), and the whole-tensor masks are held
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.pruning.first_order import first_order_importance as jimportance
from ecoflap_tpu.pruning import masks as jmasks
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.pruning.first_order import first_order_importance as timportance
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    jax_noise,
    llama_pair,
    lm_batch,
    np_batch,
    one_torch_thread,
    tiny_pair,
    to_jax,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_MB = 2
IMP_RTOL = 1e-4
NEAR_TIE = 1e-3


def setup(model_name, seed=0):
    """(JAX adapter, port adapter, JAX batch, port batch) of fresh tiny
    models with one set of weights, 4 samples a microbatch."""
    if model_name == "blip2":
        cfg, params, model = tiny_pair(seed=seed)
        batch = np_batch(cfg, n=4 * NUM_MB, seed=3)
        jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    else:
        cfg, params, model = llama_pair(seed=seed)
        batch = lm_batch(cfg, n=4 * NUM_MB, seqlen=16, seed=7)
        jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    return jad, tad, to_jax(batch), to_torch(batch)


def jax_weights(jad, params):
    return {t.name: np.asarray(t.get(params)) for t in jad.targets()}


def port_weights(tad):
    return {t.name: t.weight(tad.model).numpy() for t in tad.targets()}


def prune_both(model_name, name, cfg, seed=0, key=5):
    jad, tad, jb, tb = setup(model_name, seed)
    jparams, jdict = jload(name, jad, jb, NUM_MB,
                           dict(cfg, key=jax.random.PRNGKey(key))).prune()
    pruner = tload(name, tad, tb, NUM_MB,
                   dict(cfg, noise=jax_noise(jax.random.PRNGKey(key))))
    _, tdict = pruner.prune()
    assert jdict is None and tdict is None
    return jax_weights(jad, jparams), port_weights(tad), pruner


GLOBAL = dict(prune_spec="2-0.5-1.0-1.0", is_global=True, iteration=3, verbose=False)


@pytest.mark.parametrize("model_name", ["blip2", "llama"])
def test_global_magnitude_matches_jax(model_name):
    want, got, pruner = prune_both(model_name, "blipt5_global_mag_pruner", GLOBAL)
    zeros = total = 0
    for k in want:
        np.testing.assert_array_equal(got[k] == 0, want[k] == 0, err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        zeros += int((got[k] == 0).sum())
        total += got[k].size
    assert abs(zeros / total - 0.5) < 1e-3
    assert [k for k in pruner.phase_times if k.endswith("_select_s")] == [
        f"iteration_{i}_select_s" for i in (1, 2, 3)]


def test_global_magnitude_ratios_differ_per_tensor():
    """One threshold over all targets: the tensors' zero shares spread
    around the target, as they do not under a per-tensor threshold."""
    _, got, _ = prune_both("blip2", "blipt5_global_mag_pruner", GLOBAL)
    shares = [float((w == 0).mean()) for w in got.values()]
    assert max(shares) - min(shares) > 0.1


def jax_importance(model_name, method="GradMagAbs"):
    jad, tad, jb, tb = setup(model_name)
    batches = [jax.tree_util.tree_map(lambda x: x.reshape(NUM_MB, -1, *x.shape[1:])[b], jb)
               for b in range(NUM_MB)]
    return jimportance(jad.loss_fn, jad.params, batches, jad.targets(), method), tad, tb


@pytest.fixture(scope="module")
def gradmagabs():
    """{model name: (JAX |W| |G| importances, port adapter, port batch)}."""
    return {m: jax_importance(m) for m in ("blip2", "llama")}


@pytest.mark.parametrize("model_name", ["blip2", "llama"])
def test_gradmagabs_importance_matches_jax(gradmagabs, model_name):
    want, tad, tb = gradmagabs[model_name]
    for plans in (tad.build_mezo_plans(tad.model, tb), None):
        got = timportance(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(),
                          "GradMagAbs", plans=plans)
        assert list(got) == [t.name for t in tad.targets()]
        floor = 1e-6 * max(float(np.asarray(v).max()) for v in want.values())
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=IMP_RTOL,
                                       atol=floor, err_msg=k)


@pytest.mark.parametrize("method", ["GradOnly", "GradMagSquare"])
def test_other_importances_match_jax(method):
    want, tad, tb = jax_importance("llama", method)
    got = timportance(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), method,
                      plans=tad.build_mezo_plans(tad.model, tb))
    floor = 1e-6 * max(float(np.asarray(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=IMP_RTOL,
                                   atol=floor, err_msg=k)


def near_tie_check(want, got, importance, p):
    """Masks of one global step: equal except on entries whose JAX
    importance lies within NEAR_TIE of the threshold."""
    flat = np.sort(np.concatenate([np.asarray(v).reshape(-1) for v in importance.values()]))
    thr = flat[int(p * flat.size) - 1]
    differ = 0
    for k in want:
        bad = (got[k] == 0) != (want[k] == 0)
        differ += int(bad.sum())
        imp = np.asarray(importance[k])[bad]
        assert np.all(np.abs(imp - thr) <= NEAR_TIE * thr), (k, imp, thr)
    return differ


@pytest.mark.parametrize("model_name", ["blip2", "llama"])
def test_global_gradmagabs_matches_jax(gradmagabs, model_name):
    """One step, against the JAX step (its importances through its
    ``global_mask``): masks equal outside near-ties of the threshold; three
    steps (each scoring the last one's weights): at most 1e-3 of the
    entries differ, and the sparsity matches."""
    imp = gradmagabs[model_name][0]
    jm = jmasks.global_mask(imp, 0.5)
    _, tad, _, tb = setup(model_name)
    tload("blipt5_global_gradmagabs_pruner", tad, tb, NUM_MB,
          dict(GLOBAL, iteration=1)).prune()
    near_tie_check({k: np.asarray(v) for k, v in jm.items()}, port_weights(tad), imp, 0.5)
    want, got, _ = prune_both(model_name, "blipt5_global_gradmagabs_pruner", GLOBAL)
    total = sum(v.size for v in want.values())
    differ = sum(int(((got[k] == 0) != (want[k] == 0)).sum()) for k in want)
    assert differ <= 1e-3 * total, differ
    for k in want:
        keep = (got[k] != 0) & (want[k] != 0)
        np.testing.assert_array_equal(got[k][keep], want[k][keep], err_msg=k)
    assert abs(sum(int((w == 0).sum()) for w in got.values()) / total - 0.5) < 1e-3


def test_global_mezo_masks_match_jax():
    """Whole-tensor masks from scalar scores, the noise replayed; one step
    and one microbatch of 4, so JAX's serial cycle stays short (the steps'
    masking of scores is held by the magnitude and |W| |G| tests)."""
    cfg = dict(GLOBAL, iteration=1, num_samples=4, noise_eps=0.2)
    want, got, pruner = prune_both("blip2", "blipt5_global_mezo_pruner", cfg)
    kept = 0
    for k in want:
        w0, g0 = want[k] == 0, got[k] == 0
        assert w0.all() or not w0.any(), k  # whole tensors
        np.testing.assert_array_equal(g0, w0, err_msg=k)
        kept += int(not g0.all())
    assert kept == 48 - int(0.5 * 48)
    assert len(pruner.leaf_scores) == 48


def test_global_mezo_launches_the_serial_cycle_per_target():
    """No suffix plans: every target takes the serial in-place cycle on the
    full loss, three in-place perturbations per target, microbatch and
    step (kernel 1 on the card; here its plain version, counted by the
    wrapper only on a CUDA tensor, so the hook's calls are counted)."""
    _, tad, _, tb = setup("blip2")
    calls = []

    def noise(ti, b, n, shape):
        calls.append((ti, b, n))
        return torch.zeros(shape)

    pruner = tload("blipt5_global_mezo_pruner", tad, tb, NUM_MB,
                   dict(GLOBAL, iteration=2, noise=noise))
    pruner.prune()
    targets = len(tad.targets())
    assert len(calls) == 3 * targets * NUM_MB * 2
    assert sorted(set(calls)) == [(t, b, 0) for t in range(targets) for b in range(NUM_MB)]


@pytest.mark.parametrize("total, num_mb, want", [(128, 16, (64, 8)), (16, 4, (16, 4)),
                                                  (130, 13, (60, 6))])
def test_scores_the_first_num_samples_as_jax(total, num_mb, want):
    """The default 64 samples in whole microbatches: 64 of 128 at batch 8."""
    from ecoflap_tpu.pruning.pruners import GlobalPruner as JGlobal
    from ecoflap_tpu_torch.pruning.pruners import GlobalPruner as TGlobal

    data = np.arange(total * 3).reshape(total, 3)
    jdata, jn = JGlobal(None, {"x": jnp.asarray(data)}, num_mb)._score_data()
    tdata, tn = TGlobal(None, {"x": torch.from_numpy(data)}, num_mb)._score_data()
    assert (tdata["x"].shape[0], tn) == (jdata["x"].shape[0], jn) == want
    np.testing.assert_array_equal(tdata["x"].numpy(), np.asarray(jdata["x"]))


def test_llama_magnitude_pruner_is_global_without_is_global():
    """Under the two-stage configuration a run without --is_global passes,
    ``llama_magnitude_pruner`` keeps its constructor's ``is_global=True``
    and prunes by one threshold, as JAX does, not tensor by tensor."""
    cfg = dict(stack_specs={"model.layers": "2-0.5-1.0-1.0"}, prune_spec="2-0.5-1.0-1.0",
               sparsity_ratio_granularity=None, max_sparsity_per_layer=0.8,
               score_method="MEZO-GradOnly_sum", num_data_first_stage=8, verbose=False)
    want, got, pruner = prune_both("llama", "llama_magnitude_pruner", cfg)
    assert pruner.is_global and pruner.iteration == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    shares = [float((w == 0).mean()) for w in got.values()]
    assert max(shares) - min(shares) > 0.02


def test_per_model_masks_match_jax():
    """One threshold per submodel prefix: ``visual_encoder``, then
    ``t5_model`` for both T5 stacks (twice, to the same masks)."""
    cfg = dict(GLOBAL, iteration=2, prune_per_model=True)
    want, got, _ = prune_both("blip2", "blipt5_global_mag_pruner", cfg)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for prefix in ("visual_encoder", "t5_model"):
        sub = [w for k, w in got.items() if k.startswith(prefix)]
        share = sum(int((w == 0).sum()) for w in sub) / sum(w.size for w in sub)
        assert abs(share - 0.5) < 1e-3, prefix


def test_layerwise_masks_prune_each_tensor_to_its_share():
    """``is_global=False``: the per-tensor masks of masks.layerwise_mask
    (held against JAX in tests/test_torch_masks.py), each tensor at the
    step's share."""
    _, tad, _, tb = setup("blip2")
    tload("blipt5_global_mag_pruner", tad, tb, NUM_MB,
          dict(GLOBAL, iteration=2, is_global=False)).prune()
    for k, w in port_weights(tad).items():
        assert (w == 0).sum() == int(0.5 * w.size), k
