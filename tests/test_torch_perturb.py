"""The port's perturbation kernel, through its plain PyTorch version (no CUDA
kernel can run here; chip_smoke.py holds the kernel against this version on
the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu_torch.ops import perturb as P
from ecoflap_tpu_torch.pruning.mezo import perturb_seed


def _u32(*vals):
    return tuple(torch.tensor([v], dtype=torch.int64) for v in vals)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_matches_random123_known_answers(ctr, key, want):
    got = P.philox4x32_10(_u32(*ctr), key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_limbs_match_exact_product():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2 ** 32, size=10_000, dtype=np.uint64)
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = P._mulhilo(m, torch.from_numpy(c.astype(np.int64)))
        full = [int(x) * m for x in c]
        assert [h for h in hi.tolist()] == [f >> 32 for f in full]
        assert [x for x in lo.tolist()] == [f & 0xFFFFFFFF for f in full]


def test_words_to_normal_matches_the_tpu_kernel_transform():
    """numpy transcription of ecoflap_tpu/ops/perturb.py:61-68, float32
    throughout except log and cos, which are evaluated in float64 and
    rounded once to float32 (correctly rounded, in practice).

    numpy's own float32 log and cos are SIMD code whose argument reduction
    assumes round-to-nearest: on a thread whose floating-point rounding mode
    is directed, they drift by up to 4.4e-5 on some 7% of these inputs,
    where torch's stay within 3.3e-6 and the float64 ones within 3.5e-6 of
    their round-to-nearest results. A reference built on numpy's float32
    functions therefore failed whenever the test process ran with another
    rounding mode. This one agrees with the port within 1e-6 when both run
    in the same mode, and within 3.5e-6 when only one of them does."""
    rng = np.random.default_rng(1)
    b1 = rng.integers(0, 2 ** 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    b2 = rng.integers(0, 2 ** 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    b1[:4] = [0, 255, 256, 0xFFFFFFFF]  # u1 = 0 and 2^-24: the clamp
    u1 = (b1 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    u2 = (b2 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    u1 = np.maximum(u1, np.float32(1e-7))
    log_u1 = np.log(u1.astype(np.float64)).astype(np.float32)
    cos_arg = np.cos((np.float32(2.0 * np.pi) * u2).astype(np.float64)).astype(np.float32)
    want = (np.sqrt(np.float32(-2.0) * log_u1) * cos_arg).astype(np.float32)
    got = P.words_to_normal(torch.from_numpy(b1.astype(np.int64)),
                            torch.from_numpy(b2.astype(np.int64))).numpy()
    # float32 log/cos against correctly rounded ones: a few ulp of |z| <= 5.7
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_plain_version_matches_the_jax_kernel_in_interpret_mode():
    """The Pallas PRNG is stubbed to zero bits in interpret mode, so the JAX
    kernel adds scale * sqrt(-2 ln 1e-7) everywhere; the port's plain
    version fed zero words must do the same, on block 2 only."""
    from jax.experimental.pallas import tpu as pltpu

    from ecoflap_tpu.ops.perturb import perturb_block_inplace

    leaf = np.random.default_rng(2).normal(size=(4, 304, 640)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        got_jax = np.asarray(perturb_block_inplace(jnp.asarray(leaf), 2, 3, 1e-2))
    t = torch.from_numpy(leaf.copy())
    zero = torch.zeros(1, dtype=torch.int64)
    P.perturb_inplace_ref(t[2], 3, 1e-2, words=(zero, zero))
    got = t.numpy()
    # one float32 rounding of w + 0.01 * 5.68 on |w| <= ~5: <= 1e-6
    np.testing.assert_allclose(got[2], got_jax[2], rtol=0, atol=1e-6)
    assert np.abs(got[2] - leaf[2]).min() > 0.05  # block 2 really moved
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], got_jax[i])
        np.testing.assert_array_equal(got[i], leaf[i])


def test_same_seed_same_noise_other_seed_other_noise():
    a = torch.zeros(64, 96)
    b = torch.zeros(64, 96)
    c = torch.zeros(64, 96)
    P.perturb_inplace(a, 11, 1.0)
    P.perturb_inplace(b, 11, 1.0)
    P.perturb_inplace(c, 12, 1.0)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_antithetic_pair_is_exact(dtype):
    plus = torch.zeros(128, 256, dtype=dtype)
    minus = torch.zeros(128, 256, dtype=dtype)
    P.perturb_inplace(plus, 7, 1e-3)
    P.perturb_inplace(minus, 7, -1e-3)
    assert torch.equal(plus, -minus)


def test_antithetic_cycle_restores_and_leaves_other_blocks_alone():
    """+eps, -2eps, +eps restores within one rounding (tests/test_ops.py:79-83)."""
    leaf = torch.ones(3, 256, 512)
    for s in (1e-3, -2e-3, 1e-3):
        P.perturb_block_inplace(leaf, 1, 7, s)
    assert (leaf[1] - 1).abs().max().item() <= 1e-6
    assert torch.equal(leaf[0], torch.ones(256, 512))
    assert torch.equal(leaf[2], torch.ones(256, 512))


def test_noise_statistics():
    """The checks of tests/test_ops.py:37-39 on the port's stream."""
    w = torch.zeros(256, 512)
    P.perturb_inplace(w, 7, 1e-3)
    z = w / 1e-3
    assert abs(z.mean().item()) < 0.02
    assert abs(z.std().item() - 1.0) < 0.02
    assert 0.29 < (z.abs() > 1.0).float().mean().item() < 0.35


def test_ragged_shape_and_bf16_single_rounding():
    w = (torch.randn(301, 577, generator=torch.Generator().manual_seed(0)) * 0.02)
    wb = w.to(torch.bfloat16)
    P.perturb_inplace(wb, 5, 1e-3)
    ref = w.to(torch.bfloat16).float().clone()
    P.perturb_inplace(ref, 5, 1e-3)  # same math in float32, rounded once below
    assert torch.equal(wb, ref.to(torch.bfloat16))


def test_cpu_tensor_takes_the_plain_version_without_counting_a_launch():
    before = P.perturb_inplace.launches
    a = torch.zeros(10, 10)
    b = torch.zeros(10, 10)
    P.perturb_inplace(a, 3, 0.5)
    P.perturb_inplace_ref(b, 3, 0.5)
    assert torch.equal(a, b)
    assert P.perturb_inplace.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 4, dtype=torch.float16),
    torch.zeros(4, 8).t(),
    torch.zeros(0, 4),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        P.perturb_inplace(bad, 1, 1e-3)


def test_perturb_seeds_are_deterministic_64_bit_and_distinct():
    seeds = {perturb_seed(42, t, b, 0) for t in range(50) for b in range(4)}
    assert len(seeds) == 200
    assert all(0 <= s < 2 ** 64 for s in seeds)
    assert perturb_seed(42, 3, 1, 0) == perturb_seed(42, 3, 1, 0)


@pytest.mark.parametrize("shape", [(64, 96), (301, 577), (1, 1), (7, 1029)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_place_equals_in_place_and_leaves_the_input(shape, dtype):
    """``perturb`` (kernel 2's function) gives the in-place result bit for
    bit, on any 2-D shape, and does not touch its input."""
    w = (torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 0.02).to(dtype)
    keep = w.clone()
    want = P.perturb_inplace_ref(w.clone(), 9, 1e-3)
    for fn in (P.perturb_ref, P.perturb):
        got = fn(w, 9, 1e-3)
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got, want)
        assert torch.equal(w, keep)


def test_out_of_place_on_the_cpu_counts_no_launch_and_takes_2d_only():
    before = P.perturb.launches
    P.perturb(torch.zeros(5, 7), 3, 0.5)
    assert P.perturb.launches == before
    with pytest.raises(ValueError, match="2-D"):
        P.perturb(torch.zeros(2, 3, 4), 3, 0.5)
    with pytest.raises((TypeError, ValueError)):
        P.perturb(torch.zeros(4, 4, dtype=torch.float16), 3, 0.5)
