"""The plain reference against the port at test sizes, in float32 on the
CPU: the noise stream, the calibration loss, the zero-shot logits, the
allocation and the Wanda masks."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import allocator, fine, mezo
from portbench.reference import blip2_t5 as RB
from portbench.reference import eva_clip as RC
from portbench.reference.numerics import Prec
from portbench.tests.conftest import DATA, REPO

F32 = Prec("f32")


def _load(family, config):
    from portbench.harness import load_file

    cfg = json.loads((DATA / f"{config}.json").read_text())
    fam = load_file(REPO / "portbench" / "families" / f"{family}.py")
    return cfg, fam


@pytest.mark.parametrize("seed", [0, 5, 2 ** 40 + 3])
def test_noise_stream_is_the_kernels(seed):
    from ecoflap_tpu_torch.ops.perturb import normals_ref
    from ecoflap_tpu_torch.pruning.mezo import perturb_seed

    assert mezo.kernel_seed(seed, 3, 0) == perturb_seed(seed, 3, 0, 0)
    assert torch.equal(mezo.normals(1001, seed, "cpu"), normals_ref(1001, seed, "cpu"))


def test_blip2_loss_matches_the_port():
    cfg, fam = _load("blip2_t5", "tiny-blip2")
    mix = json.loads((DATA / "tiny-zeroth.json").read_text())
    model, _ = fam.build(cfg, "cpu", torch.float32)
    w = weights.make(weights.param_list(model), cfg["init"], 3, "cpu")
    weights.load(model, w)
    batch = fam.calibration(cfg, mix, 3, "cpu")
    with torch.no_grad():
        want = model.per_sample_loss(batch)
    got = RB.per_sample_loss(w, cfg, F32, batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_eva_clip_logits_match_the_port():
    cfg, fam = _load("eva_clip", "tiny-eva-clip")
    mix = json.loads((DATA / "tiny-zeroshot.json").read_text())
    model = fam.build(cfg, "cpu", torch.float32)
    w = weights.make(weights.param_list(model), cfg["init"], 4, "cpu")
    weights.load(model, w)
    ids = fam.prompts(cfg, mix, 4, "cpu")
    c, k, n = ids.shape
    images = torch.from_numpy(fam.images(cfg, mix, 4, "cpu")[0])
    with torch.no_grad():
        want = model.predict(images, model.zero_shot_classifier(ids.reshape(c * k, n), c))
    got = RC.logits(w, cfg, F32, images, RC.class_embeddings(w, cfg, F32, ids))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_allocation_matches_the_port():
    from ecoflap_tpu_torch.pruning.allocator import compute_sparsity_per_group

    rng = np.random.default_rng(0)
    scores = {f"g{i}": float(rng.exponential()) for i in range(40)}
    sizes = {g: int(rng.integers(1000, 9000)) for g in scores}
    keep = int(sum(sizes.values()) * 0.5)
    assert allocator.allocate(keep, scores, sizes, 0.6) == \
        compute_sparsity_per_group(keep, scores, sizes, 0.6)


@pytest.mark.parametrize("per_row", [True, False])
def test_wanda_mask_matches_the_port(per_row):
    from ecoflap_tpu_torch.pruning.engine import make_wanda_prune_fn

    g = torch.Generator().manual_seed(1)
    w = torch.randn(48, 64, generator=g)
    sq = torch.rand(64, generator=g) * 10
    want = make_wanda_prune_fn(per_row)(w, sq, 16.0, 0.4375)
    assert torch.equal(fine.wanda_mask(w, sq, 16.0, 0.4375, per_row), want)
