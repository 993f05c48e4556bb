"""The yardstick's arithmetic against counts made by hand at test sizes."""

from __future__ import annotations

import json

import pytest

from portbench import counts
from portbench.tests.conftest import DATA

TINY = json.loads((DATA / "tiny-blip2.json").read_text())
MIX = json.loads((DATA / "tiny-zeroth.json").read_text())


def test_vit_block_by_hand():
    # 16 px, patch 4: 16 patches + cls = 17 tokens; width 32, MLP 64
    t, d, f = 17, 32, 64
    want = 2 * t * d * 3 * d + 2 * t * d * d + 2 * (2 * t * d * f) + 2 * 2 * t * t * d
    assert counts.vit_block_flops(TINY["vit"]) == want


def test_t5_blocks_by_hand():
    t5 = TINY["t5"]  # d 32, inner 4 x 8 = 32, d_ff 64
    s, se = 8, 12
    enc = 3 * 2 * s * 32 * 32 + 2 * s * 32 * 32 + 2 * 2 * s * s * 32 + 2 * (2 * s * 32 * 64) \
        + 2 * s * 64 * 32
    assert counts.t5_enc_block_flops(t5, s) == enc
    dec = (3 * 2 * s * 32 * 32 + 2 * s * 32 * 32 + 2 * 2 * s * s * 32
           + 2 * s * 32 * 32 + 2 * (2 * se * 32 * 32) + 2 * s * 32 * 32 + 2 * 2 * s * se * 32
           + 2 * (2 * s * 32 * 64) + 2 * s * 64 * 32)
    assert counts.t5_dec_block_flops(t5, s, se) == dec


def test_prune_job_parts_add_up():
    p = counts.blip2_parts(TINY, MIX)
    got = counts.blip2_prune_job_flops(TINY, MIX)
    assert got["total"] == got["coarse"] + got["fine"]
    n = MIX["num_samples"]
    vit_all = p["vit_embed"] + 3 * p["vit_block"]
    enc_all, dec_all = 2 * p["enc_block"], 2 * p["dec_block"]
    fine = (n * (p["vit_embed"] + 2 * 3 * p["vit_block"])
            + n * (vit_all + p["qformer"] + 2 * enc_all)
            + n * (vit_all + p["qformer"] + enc_all + 2 * dec_all))
    assert got["fine"] == pytest.approx(fine)
    # one lane of the last ViT block: that block and everything after it
    b = MIX["num_data_first_stage"]
    last_vit = 4 * 2 * b * (p["vit_block"] + p["qformer"] + enc_all + dec_all + p["lm_head"])
    assert got["coarse"] > last_vit


def test_perturb_bound_by_hand():
    n = 1408 * 4224
    assert counts.perturb_bound_s(n) == pytest.approx(2 * n * 2 / 3.35e12)
    # bytes bound it: 29.5 float32 operations an element are under 4 bytes' time
    assert counts.PERTURB_OPS_PER_ELEMENT == 29.5
    p = counts.blip2_perturb_bound_s(TINY, MIX)
    assert p["launches"] == 2 * (3 * 4 + 2 * 7 + 2 * 11)


def test_eva_clip_image_by_hand():
    cfg = json.loads((DATA / "tiny-eva-clip.json").read_text())
    v = cfg["visual"]
    want = (2 * 16 * 48 * 32 + 3 * counts.vit_block_flops(v) + 2 * 32 * 16 + 2 * 16 * 10)
    assert counts.eva_clip_image_flops(cfg, 10) == want
