"""The port's MeZO lane ensemble (``SuffixPlan.lane_losses`` and the group
units of ``mezo_leaf_scores``) and ``shared`` noise against the JAX package's
lane ensemble, and against the port's own serial in-place path, with the
same noise.

Noise: the ``noise`` hook replays the JAX draws (tests/torch_parity.py):
normal(fold_in(fold_in(fold_in(key, target), b), n)) per (target,
microbatch, draw) in ``per_batch`` mode, normal(fold_in(fold_in(key,
target), n)) per (target, draw) in ``shared`` mode, the key chains both
JAX paths share (mezo.py:373-381, 390-397, 413).

Tolerance, as tests/test_torch_mezo.py states it: a score is a divided
difference |L+ - L-| / 2eps of float32 losses (~5). The packages sum in other
orders, the lanes' suffix runs at K times the batch (other GEMM blockings),
and the serial path's in-place cycle restores weights to one rounding, so
each loss carries a few float32 ulps (~5e-7 each); over 2 microbatches at
eps = 0.2 that is an absolute floor of ~2e-5 on top of rtol 1e-3. The
ensemble and the serial path draw the same z, so the same bound holds
between them."""

import jax
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.pruning.mezo import mezo_leaf_scores as jscores
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.ops import perturb as P
from ecoflap_tpu_torch.pruning import mezo as tmezo
from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores as tscores
from ecoflap_tpu_torch.pruning.plans import START_KEY, repeat_batch
from tests.torch_parity import (
    jax_noise,
    llama_pair,
    lm_batch,
    np_batch,
    one_torch_thread,  # noqa: F401 (a fixture)
    tiny_pair,
    to_jax,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPS = 0.2
RTOL, ATOL = 1e-3, 2e-5
MODES = ("per_batch", "shared")


def _close(got, want):
    assert list(got) == list(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= RTOL * abs(w) + ATOL, (k, got[k], w)


@pytest.fixture(scope="module")
def blip():
    cfg, params, model = tiny_pair(seed=0)
    batch = np_batch(cfg, n=8, seed=0)
    return cfg, params, model, batch


# the JAX ensemble traces anew per call and per plan (some 5 s each here),
# so each plan is held against it in one mode: per_batch on the ViT's (4
# lanes, the longest finish) and the decoder's (11 lanes), shared on the
# encoder's, the plan with extra batch data (the fused mask, repeated per
# lane). tests/test_torch_mezo.py holds the serial path against JAX on all
# 48 targets, and the ensemble is held against the serial path on all 48
# in both modes here.
JAX_STACKS = {"per_batch": ("visual_encoder.blocks.", "t5_model.decoder.block."),
              "shared": ("t5_model.encoder.block.",)}


@pytest.fixture(scope="module")
def blip_scores(blip):
    """{mode: (JAX ensemble on the mode's stacks, port ensemble on the same
    targets, port ensemble on all 48, port serial on all 48)}, 2
    microbatches."""
    cfg, params, model, batch = blip
    key = jax.random.PRNGKey(7)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    out = {}
    for mode in MODES:
        pick = JAX_STACKS[mode]
        jt = [t for t in jad.targets() if t.name.startswith(pick)]
        tt = [t for t in tad.targets() if t.name.startswith(pick)]
        jplans = [p for p in jad.build_mezo_plans(params, jb)
                  if any(p.match(t.name) for t in jt)]
        js = jscores(jad.loss_fn, params, jb, 2, jt, eps=EPS, key=key,
                     noise_mode=mode, loss_plans=jplans)
        vs_jax = tscores(tad.loss_fn, model, tb, 2, tt, eps=EPS, noise_mode=mode,
                         noise=jax_noise(key), ensemble=True,
                         loss_plans=tad.build_mezo_plans(model, tb))
        port = {ens: tscores(tad.loss_fn, model, tb, 2, tad.targets(), eps=EPS,
                             noise_mode=mode, noise=jax_noise(key), ensemble=ens,
                             loss_plans=tad.build_mezo_plans(model, tb))
                for ens in (True, False)}
        out[mode] = ({k: float(v) for k, v in js.items()}, vs_jax, port[True],
                     port[False])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_ensemble_matches_the_jax_ensemble(blip_scores, mode):
    js, got, ens, _ = blip_scores[mode]
    assert len(js) == (12 + 22 if mode == "per_batch" else 14)
    _close(got, js)
    assert len(set(ens.values())) == len(ens) == 48  # distinct, non-degenerate


@pytest.mark.parametrize("mode", MODES)
def test_ensemble_matches_the_serial_path(blip_scores, mode):
    _, _, ens, serial = blip_scores[mode]
    _close(ens, serial)


def test_shared_and_per_batch_draw_different_noise(blip_scores):
    """``shared`` is its own estimator: one z per (target, draw)."""
    _, _, per_batch, _ = blip_scores["per_batch"]
    _, _, shared, _ = blip_scores["shared"]
    assert all(np.isfinite(v) and v >= 0 for v in shared.values())
    assert sum(per_batch[k] != shared[k] for k in shared) > 40


def test_ensemble_leaves_the_weights_untouched(blip):
    """Lanes are out-of-place copies: not a bit of the model changes."""
    _, _, model, batch = blip
    tad = tblip2.make_adapter(model)
    before = {t.name: t.weight(model).clone() for t in tad.targets()}
    tb = to_torch(batch)
    tscores(tad.loss_fn, model, tb, 2, tad.targets()[:12], eps=EPS, seed=3,
            loss_plans=tad.build_mezo_plans(model, tb))
    for t in tad.targets():
        assert torch.equal(t.weight(model), before[t.name]), t.name


def test_num_noise_two_accumulates_as_jax(blip):
    """num_noise = 2, per_batch: |dL| / 2eps summed over the draws inside
    each microbatch's |.|, as the JAX ensemble does."""
    cfg, params, model, batch = blip
    key = jax.random.PRNGKey(3)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    jt = [t for t in jad.targets() if t.name.startswith("visual_encoder.blocks.0.")]
    tt = [t for t in tad.targets() if t.name.startswith("visual_encoder.blocks.0.")]
    assert len(tt) == 4
    js = jscores(jad.loss_fn, params, jb, 2, jt, eps=EPS, key=key, num_noise=2,
                 loss_plans=[p for p in jad.build_mezo_plans(params, jb)
                             if p.match(jt[0].name)])
    ts = tscores(tad.loss_fn, model, tb, 2, tt, eps=EPS, num_noise=2,
                 noise=jax_noise(key), loss_plans=tad.build_mezo_plans(model, tb))
    _close(ts, js)


def test_num_noise_two_shared_matches_the_serial_path(blip):
    """num_noise = 2, shared: the sum over draws and microbatches, the same
    on the lane ensemble as on the serial cycle (whose shared mode is held
    against JAX through the full-target fixture above)."""
    _, _, model, batch = blip
    key = jax.random.PRNGKey(3)
    tad = tblip2.make_adapter(model)
    tb = to_torch(batch)
    tt = [t for t in tad.targets() if t.name.startswith("t5_model.decoder.block.1.")]
    assert len(tt) == 11
    ens, ser = (tscores(tad.loss_fn, model, tb, 2, tt, eps=EPS, num_noise=2,
                        noise_mode="shared", noise=jax_noise(key), ensemble=e,
                        loss_plans=tad.build_mezo_plans(model, tb))
                for e in (True, False))
    _close(ens, ser)
    one = tscores(tad.loss_fn, model, tb, 2, tt, eps=EPS, noise_mode="shared",
                  noise=jax_noise(key), loss_plans=tad.build_mezo_plans(model, tb))
    assert all(ens[k] > one[k] for k in one)  # a second draw only adds


def test_group_boundaries_follow_plan_and_block(blip):
    """Targets of one block that are not contiguous, and targets no plan
    covers, interleaved: units split at every change of plan or block, and
    each score keeps its target (held against the serial path with the
    same noise, which tests/test_torch_mezo.py holds against JAX)."""
    _, _, model, batch = blip
    names = ["visual_encoder.blocks.0.attn.qkv.weight",
             "visual_encoder.blocks.0.mlp.fc1.weight",
             "t5_model.encoder.block.0.layer.0.SelfAttention.q.weight",
             "visual_encoder.blocks.1.attn.proj.weight",
             "visual_encoder.blocks.1.mlp.fc2.weight"]
    key = jax.random.PRNGKey(5)
    tad = tblip2.make_adapter(model)
    tb = to_torch(batch)
    tt = [next(t for t in tad.targets() if t.name == n) for n in names]

    def vit_plan():
        # only the ViT plan: the T5 target scores through the whole loss
        return [p for p in tad.build_mezo_plans(model, tb) if p.match(names[0])]

    units = tmezo._units(tt, vit_plan(), True)
    assert [(i0, len(g), p is not None) for i0, g, p in units] == [
        (0, 2, True), (2, 1, False), (3, 2, True)]
    ens, ser = (tscores(tad.loss_fn, model, tb, 2, tt, eps=EPS, noise=jax_noise(key),
                        loss_plans=vit_plan(), ensemble=e) for e in (True, False))
    _close(ens, ser)
    assert [u[1] for u in tmezo._units(tt, vit_plan(), False)] == [[t] for t in tt]


def test_lane_losses_equal_one_evaluation_per_lane(blip):
    """K lanes at block 1 of the ViT plan == K evaluations of the plan's
    loss with the model's weight replaced by the lane's, one at a time."""
    _, _, model, batch = blip
    tad = tblip2.make_adapter(model)
    tb = to_torch(batch)
    plan = tad.build_mezo_plans(model, tb)[0]
    group = [t for t in tad.targets() if t.name.startswith("visual_encoder.blocks.1.")]
    data = plan.prepare(model, group[0].name)
    assert data[START_KEY] == 1
    gen = torch.Generator().manual_seed(0)
    lanes = [t.weight(model) + 0.05 * torch.randn(t.weight(model).shape, generator=gen)
             for t in group]
    got = plan.lane_losses(model, data, plan.lane_paths(group), lanes)
    assert got.shape == (len(group), 8)
    for k, t in enumerate(group):
        w = t.weight(model)
        keep = w.clone()
        w.copy_(lanes[k])
        want = plan.loss_fn(model, data)
        w.copy_(keep)
        torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-6)


def test_repeat_batch_tiles_only_batch_leading_tensors():
    x = torch.arange(6.0).reshape(2, 3)
    shared = torch.zeros(1, 4)
    out = repeat_batch({"x": x, "s": (shared, x), "n": 3}, 3, 2)
    assert torch.equal(out["x"], torch.cat([x, x, x]))
    assert out["s"][0] is shared and out["s"][1].shape == (6, 3) and out["n"] == 3


@pytest.mark.parametrize("total,mb,lanes,want", [(8, 2, 4, 8), (8, 2, 3, 8),
                                                  (12, 2, 2, 4), (12, 3, 2, 6),
                                                  (16, 2, 1, 2)])
def test_shared_lane_chunks_hold_at_most_one_microbatch(total, mb, lanes, want):
    """The smallest divisor of the coarse batch that is at least microbatches
    x lanes (mezo.py:355-364): K lanes of total / chunks samples each hold
    no more than one serial microbatch."""
    c = tmezo._lane_chunks(total, mb, lanes)
    assert c == want and total % c == 0
    assert lanes * (total // c) <= max(total // mb, lanes)


def _count_kernel_calls(monkeypatch):
    calls = {"perturb": 0, "perturb_inplace": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tmezo, "perturb", counting("perturb", P.perturb))
    monkeypatch.setattr(tmezo, "perturb_inplace",
                        counting("perturb_inplace", P.perturb_inplace))
    return calls


def test_each_plan_chooses_its_path_unless_told(blip, monkeypatch):
    """``ensemble=None`` follows ``SuffixPlan.lanes``: LLaMA's plan takes the
    serial cycle (kernel 1 only), BLIP-2's the ensemble (kernel 2 only);
    ``ensemble=True`` sends LLaMA's targets to the ensemble too."""
    cfg, _, model = llama_pair(seed=0)
    tb = to_torch(lm_batch(cfg, n=4, seqlen=16, seed=4))
    tad = tllama.make_adapter(model)
    assert [p.lanes for p in tad.build_mezo_plans(model, tb)] == [False]
    calls = _count_kernel_calls(monkeypatch)
    targets = tad.targets()[:7]  # block 0
    tscores(tad.loss_fn, model, tb, 2, targets, eps=EPS, seed=1,
            loss_plans=tad.build_mezo_plans(model, tb))
    assert calls == {"perturb": 0, "perturb_inplace": 3 * 7 * 2}
    calls.update(perturb=0, perturb_inplace=0)
    tscores(tad.loss_fn, model, tb, 2, targets, eps=EPS, seed=1, ensemble=True,
            loss_plans=tad.build_mezo_plans(model, tb))
    assert calls == {"perturb": 2 * 7 * 2, "perturb_inplace": 0}
    _, _, bmodel, bbatch = blip
    bad = tblip2.make_adapter(bmodel)
    plans = bad.build_mezo_plans(bmodel, to_torch(bbatch))
    assert len(plans) == 3 and all(p.lanes for p in plans)


def test_ensemble_launches_two_out_of_place_perturbations_per_draw(blip, monkeypatch):
    """The ensemble calls kernel 2's wrapper twice per (target, microbatch,
    draw) and kernel 1's never: 2 x 588 x 4 on the BLIP-2 XL path. The
    serial path calls kernel 1's three times and kernel 2's never."""
    _, _, model, batch = blip
    tad = tblip2.make_adapter(model)
    tb = to_torch(batch)
    calls = _count_kernel_calls(monkeypatch)
    targets = tad.targets()[:4]  # ViT block 0
    tscores(tad.loss_fn, model, tb, 2, targets, eps=EPS, seed=1, num_noise=2,
            loss_plans=tad.build_mezo_plans(model, tb))
    assert calls == {"perturb": 2 * 4 * 2 * 2, "perturb_inplace": 0}
    calls.update(perturb=0, perturb_inplace=0)
    tscores(tad.loss_fn, model, tb, 2, targets[:4], eps=EPS, seed=1,
            loss_plans=tad.build_mezo_plans(model, tb), ensemble=False)
    assert calls == {"perturb": 0, "perturb_inplace": 3 * 4 * 2}
    calls.update(perturb=0, perturb_inplace=0)
    tscores(tad.loss_fn, model, tb, 2, targets[:4], eps=EPS, seed=1,
            noise_mode="shared", loss_plans=tad.build_mezo_plans(model, tb))
    assert calls == {"perturb": 2 * 4, "perturb_inplace": 0}


def test_kernel_seeds_equal_the_serial_paths():
    """Lane k of a group starting at target i0 draws from the serial path's
    seed of target i0 + k; shared mode's seeds differ from every per-batch
    seed of the same target and draw."""
    assert tmezo.perturb_seed(42, 5, 1, 0) == tmezo.perturb_seed(42, 5, 1, 0)
    shared = {tmezo.perturb_seed(42, t, None, n) for t in range(4) for n in range(2)}
    per_batch = {tmezo.perturb_seed(42, t, b, n)
                 for t in range(4) for b in range(4) for n in range(2)}
    assert len(shared) == 8 and not shared & per_batch


@pytest.fixture(scope="module")
def llama_scores():
    cfg, params, model = llama_pair(seed=0)
    batch = lm_batch(cfg, n=8, seqlen=16, seed=4)
    key = jax.random.PRNGKey(7)
    jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    out = {}
    for mode in MODES:
        js = jscores(jad.loss_fn, params, jb, 2, jad.targets(), eps=EPS, key=key,
                     noise_mode=mode, loss_plans=jad.build_mezo_plans(params, jb))
        ts = tscores(tad.loss_fn, model, tb, 2, tad.targets(), eps=EPS,
                     noise_mode=mode, noise=jax_noise(key), ensemble=True,
                     loss_plans=tad.build_mezo_plans(model, tb))
        out[mode] = ({k: float(v) for k, v in js.items()}, ts)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_llama_ensemble_matches_the_jax_ensemble(llama_scores, mode):
    """Tiny LLaMA: 7 lanes a block, finished lane by lane (``finish_lanes=1``)."""
    js, ts = llama_scores[mode]
    assert len(ts) == 14
    _close(ts, js)
    assert len(set(ts.values())) == len(ts)


def test_cli_shared_mode_on_the_cpu(tmp_path):
    """``--noise_mode shared`` through the port's CLI, tiny BLIP-2: the 48
    reference keys, ratios under the cap, the budget spent, and finite
    distinct scores."""
    from ecoflap_tpu_torch.cli.prune import main
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml

    argv = ["--model", "blip2_t5", "--model_scale", "tiny", "--device", "cpu",
            "--vit_prune_spec", "3-0.5-1.0-1.0", "--t5_prune_spec", "2-0.5-1.0-1.0",
            "--sparsity_ratio_granularity", "block", "--max_sparsity_per_layer", "0.6",
            "--num_samples", "4", "--batch_size", "4", "--num_data_first_stage", "4",
            "--noise_eps", "0.05", "--output_dir", str(tmp_path)]
    shared = main(argv + ["--noise_mode", "shared"])
    sd = read_flat_yaml(shared["sparsity_dict"])
    assert len(sd) == 48 and max(sd.values()) <= 0.6 + 1e-9
    assert abs(shared["prunable_sparsity"] - 0.5) < 0.02
    vals = list(shared["leaf_scores"].values())
    assert all(np.isfinite(v) and v >= 0 for v in vals) and len(set(vals)) > 40
