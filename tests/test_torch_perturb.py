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

    The port's transform rounds at the same points and also takes log and
    cos in float64, so the two agree to the bit in practice; the tolerance
    is a few float32 ulp of |z| <= 5.7. Its former float32 version went
    through the CPU's float32 vector math and, in some runs of the whole
    suite under six pytest-xdist workers, drifted from this reference by up
    to 4.3e-5 on 5% of these inputs, a relative error of up to 5e-5 that no
    rounding mode, denormal mode, vector-math accuracy mode or thread layout
    reproduced alone."""
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
    # the same roundings on both sides: at most a few ulp of |z| <= 5.7
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_sin_branch_matches_correctly_rounded_log_and_sin():
    """The sin branch of the same transform, against the same float64
    construction as the cos branch's reference above."""
    rng = np.random.default_rng(2)
    b1 = rng.integers(0, 2 ** 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    b2 = rng.integers(0, 2 ** 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    b1[:2] = [0, 0xFFFFFFFF]
    u1 = (b1 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    u2 = (b2 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    u1 = np.maximum(u1, np.float32(1e-7))
    radius = np.sqrt(np.float32(-2.0) * np.log(u1.astype(np.float64)).astype(np.float32))
    sin_arg = np.sin((np.float32(2.0 * np.pi) * u2).astype(np.float64)).astype(np.float32)
    want = (radius * sin_arg).astype(np.float32)
    cos_z, sin_z = P.box_muller(torch.from_numpy(b1.astype(np.int64)),
                                torch.from_numpy(b2.astype(np.int64)))
    np.testing.assert_allclose(sin_z.numpy(), want, rtol=0, atol=4e-6)
    assert torch.equal(cos_z, P.words_to_normal(torch.from_numpy(b1.astype(np.int64)),
                                                torch.from_numpy(b2.astype(np.int64))))


@pytest.mark.parametrize("n", [1, 3, 4, 7, 1000, 40_001])
def test_elements_take_both_branches_of_two_word_pairs(n):
    """Elements 4j, 4j + 1 are the cos and sin branches of words (0, 1) of
    counter (lo(j), hi(j), 0, 0); elements 4j + 2, 4j + 3 those of its words
    (2, 3): the kernel's stream."""
    seed = 0x0123456789ABCDEF
    z = P.normals_ref(n, seed, "cpu")
    assert z.shape == (n,) and z.dtype == torch.float32
    for i in sorted({0, 1, 2, 3, n // 2, n - 2, n - 1} & set(range(n))):
        w = P.philox4x32_10(_u32(i // 4, 0, 0, 0), (seed & 0xFFFFFFFF, seed >> 32))
        pair = (w[0], w[1]) if i % 4 < 2 else (w[2], w[3])
        assert torch.equal(z[i:i + 1], P.box_muller(*pair)[i % 2]), i
    assert P.ELEMENTS_PER_COUNTER == 4


@pytest.mark.parametrize("n", [208, 209, 210, 211])
def test_noise_depends_on_the_flat_index_only(n):
    """The same flat tensor gives the same z under any reshape, whatever
    n % 4 is (the last counter is then only partly used)."""
    flat = P.perturb_ref(torch.zeros(n), 21, 1.0)
    assert torch.equal(flat, P.normals_ref(n, 21, "cpu"))
    shapes = [(n,), (1, n), (n, 1)] + [(a, n // a) for a in range(2, n) if n % a == 0]
    for shape in shapes:
        got = P.perturb_ref(torch.zeros(shape), 21, 1.0)
        assert torch.equal(got.reshape(-1), flat), shape


def test_the_two_branches_of_a_pair_are_uncorrelated():
    """Over 1,048,576 draws: the cos and sin draws of each word pair, and
    neighbouring elements, correlate by less than 0.01 (the sampling spread
    of a correlation over 262,144 pairs is 0.002)."""
    z = P.normals_ref(1 << 20, 0xD1B54A32D192ED03, "cpu").double()
    q = z.view(-1, 4)

    def rho(x, y):
        x, y = x - x.mean(), y - y.mean()
        return ((x * y).sum() / ((x * x).sum() * (y * y).sum()).sqrt()).item()

    for x, y in ((q[:, 0], q[:, 1]), (q[:, 2], q[:, 3]), (z[:-1], z[1:])):
        assert abs(rho(x, y)) < 0.01
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1.0) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_view_at_an_odd_offset_perturbs_as_a_contiguous_copy(dtype):
    """leaf[1] of a (3, 301, 577) leaf starts 173,677 elements in (odd, off
    any 16-byte boundary); its noise is that of a fresh contiguous copy, and
    the out-of-place form's output lies at the view's 16-byte phase."""
    leaf = (torch.randn(3, 301, 577, generator=torch.Generator().manual_seed(4))
            * 0.02).to(dtype)
    view = leaf[1]
    assert view.storage_offset() % 2 == 1 and view.data_ptr() % 16 != 0
    copy = view.clone()
    keep = leaf.clone()
    P.perturb_block_inplace(leaf, 1, 13, 1e-3)
    P.perturb_inplace(copy, 13, 1e-3)
    assert torch.equal(leaf[1], copy)
    assert torch.equal(leaf[0], keep[0]) and torch.equal(leaf[2], keep[2])
    assert torch.equal(P.perturb(keep[1], 13, 1e-3), copy)
    out = P._empty_in_phase(keep[1])
    assert out.shape == view.shape and out.dtype == dtype and out.is_contiguous()
    assert out.data_ptr() % 16 == keep[1].data_ptr() % 16


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
