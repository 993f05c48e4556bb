"""The port's serial in-place MeZO scoring (``ensemble=False``) against the
JAX package's default (lane-ensemble) scoring with the same noise, and the
coarse stage's allocation.

Noise: the port's ``noise`` hook replays the JAX draws
normal(fold_in(fold_in(fold_in(key, target), b), n)), the key chain the
ensemble shares with the serial path (mezo.py:390-397, 405, 436).

Tolerance: a score is a divided difference |L+ - L-| / 2eps of float32
losses (~5). Reduction order differs between the packages, and the port's
in-place cycle restores weights to one rounding, so each loss carries a few
float32 ulps (~5e-7 each); over 2 microbatches at eps = 0.2 that is an
absolute floor of ~2e-5 on top of rtol 1e-3."""

import jax
import pytest

from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.pruning.allocator import compute_sparsity_per_group as jalloc
from ecoflap_tpu.pruning.mezo import mezo_group_sums as jgroup_sums
from ecoflap_tpu.pruning.mezo import mezo_leaf_scores as jscores
from ecoflap_tpu.pruning.sparsity import compute_layer_sparsity as jsparsity
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.pruning.allocator import compute_sparsity_per_group as talloc
from ecoflap_tpu_torch.pruning.mezo import mezo_group_sums as tgroup_sums
from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores as tscores
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity as tsparsity
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    jax_noise,
    np_batch,
    one_torch_thread,
    tiny_pair,
    to_jax,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPS = 0.2
RTOL, ATOL = 1e-3, 2e-5


@pytest.fixture(scope="module")
def setup():
    cfg, params, model = tiny_pair(seed=0)
    batch = np_batch(cfg, n=8, seed=0)
    return cfg, params, model, batch


@pytest.fixture(scope="module")
def scores(setup):
    cfg, params, model, batch = setup
    key = jax.random.PRNGKey(7)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    js = jscores(jad.loss_fn, params, jb, 2, jad.targets(), eps=EPS, key=key,
                 loss_plans=jad.build_mezo_plans(params, jb))
    ts = tscores(tad.loss_fn, model, tb, 2, tad.targets(), eps=EPS,
                 noise=jax_noise(key), loss_plans=tad.build_mezo_plans(model, tb),
                 ensemble=False)
    return {k: float(v) for k, v in js.items()}, ts


def test_leaf_scores_match_jax_ensemble(scores):
    js, ts = scores
    assert list(ts) == list(js) and len(ts) == 48
    for k in js:
        assert abs(ts[k] - js[k]) <= RTOL * abs(js[k]) + ATOL, (k, ts[k], js[k])
    assert len(set(ts.values())) == len(ts)  # distinct, non-degenerate scores


def test_in_place_cycle_restores_the_weights(setup, scores):
    """After scoring, every weight is back to its value up to one float32
    rounding of its perturbation (the antithetic cycle's restore)."""
    _, _, model, _ = setup
    _, _, fresh = tiny_pair(seed=0)
    for t in tblip2.make_adapter(model).targets():
        d = (t.weight(model) - t.weight(fresh)).abs().max().item()
        assert d <= 1e-6, (t.name, d)


def test_same_scores_give_equal_sparsity_dicts(setup, scores):
    """Both allocators fed one set of group scores allocate identically."""
    _, _, model, _ = setup
    js, _ = scores
    tad = tblip2.make_adapter(model)
    mapping = tad.group_mapping("block")
    gs, gn = {}, {}
    for t in tad.targets():
        g = mapping[t.name]
        gs[g] = gs.get(g, 0.0) + js[t.name]
        gn[g] = gn.get(g, 0) + t.numel(model)
    keep = int(sum(gn.values()) * 0.5)
    for cap in (0.6, 0.8):
        assert talloc(keep, gs, gn, cap) == jalloc(keep, gs, gn, cap)


@pytest.mark.parametrize("method", ["MEZO-GradMagAbs", "MEZO-GradMagSquare"])
def test_group_sums_match(setup, scores, method):
    cfg, params, model, _ = setup
    js, _ = scores
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    want = jgroup_sums(params, jad.targets(), js, method)
    got = tgroup_sums(model, tad.targets(), js, method)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def test_compute_layer_sparsity_end_to_end(setup):
    cfg, params, model, batch = setup
    _, _, model = tiny_pair(seed=0)  # unperturbed copy
    key = jax.random.PRNGKey(11)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    kw = dict(max_sparsity_per_layer=0.6, score_method="MEZO-GradOnly_sum",
              noise_eps=EPS, verbose=False)
    want = jsparsity(jad.loss_fn, params, jb, 2, jad.targets(), 0.5,
                     jad.group_mapping("block"), key=key,
                     loss_plans=jad.build_mezo_plans(params, jb), **kw)
    got = tsparsity(tad.loss_fn, model, tb, 2, tad.targets(), 0.5,
                    tad.group_mapping("block"), noise=jax_noise(key),
                    loss_plans=tad.build_mezo_plans(model, tb), **kw)
    assert list(got) == list(want) and len(got) == 48
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert max(got.values()) <= 0.6


def test_uniform_when_no_granularity_and_shared_mode_not_ported(setup):
    """No granularity gives the uniform dict; an unknown ``noise_mode``
    raises ``ValueError``. (The name is kept from before ``shared`` mode was
    ported, when this test checked its refusal; tests/test_torch_mezo_ensemble.py
    holds ``shared`` against the JAX package.)"""
    cfg, params, model, batch = setup
    tad = tblip2.make_adapter(model)
    u = tsparsity(tad.loss_fn, model, to_torch(batch), 2, tad.targets(), 0.5, None)
    assert u["anything"] == 0.5
    with pytest.raises(ValueError, match="noise_mode"):
        tscores(tad.loss_fn, model, to_torch(batch), 2, tad.targets()[:1],
                noise_mode="per_sample")
