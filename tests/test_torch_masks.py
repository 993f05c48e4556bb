"""The port's global and layerwise masks and the iterative schedule
(``ecoflap_tpu_torch/pruning/masks.py``, ``select.py``) against the JAX
package's ``ecoflap_tpu/pruning/masks.py``: exactly equal masks on
importances with exact ties, zeros, -0.0, a NaN and keep-floors below 1,
and the global selection against a sort of the concatenation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.pruning import masks as jmasks
from ecoflap_tpu_torch.pruning import masks as tmasks
from ecoflap_tpu_torch.pruning.select import float_bits, kth_smallest_bits

SHAPES = {"a": (12, 20), "b": (7, 33), "c": (1,), "d": (40, 9)}


def importances(seed, ties=True, specials=True):
    """numpy float32 importances: |N(0,1)| rounded to a few levels where
    ``ties`` (so thresholds fall inside tie classes), zeros and -0.0, and a
    NaN and an inf where ``specials``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        v = np.abs(rng.normal(size=shape)).astype(np.float32)
        if ties:
            v = np.round(v * 4) / 4
        out[k] = v
    out["a"].flat[:5] = 0.0
    out["a"].flat[5:9] = -0.0
    out["d"].flat[::17] = -0.0
    if specials:
        out["b"].flat[3] = np.nan
        out["d"].flat[7] = np.inf
    return out


def check_equal(want, got):
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k]) != 0
        g = got[k].numpy()
        assert g.dtype == np.bool_ and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("p", [0.0, 0.125, 0.354, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_mask_matches_jax(seed, p):
    imp = importances(seed)
    want = jmasks.global_mask({k: jnp.asarray(v) for k, v in imp.items()}, p)
    got = tmasks.global_mask({k: torch.from_numpy(v) for k, v in imp.items()}, p)
    check_equal(want, got)


@pytest.mark.parametrize("cap", [0.3, 0.6, 0.95])
def test_global_mask_keep_floor_matches_jax(cap):
    imp = importances(2)
    want = jmasks.global_mask({k: jnp.asarray(v) for k, v in imp.items()}, 0.5, cap)
    got = tmasks.global_mask({k: torch.from_numpy(v) for k, v in imp.items()}, 0.5, cap)
    check_equal(want, got)
    if cap >= 0.5:  # a floor above 1 - p puts the threshold in its own ties
        for k, m in got.items():
            assert m.sum().item() >= int(m.numel() * (1 - cap)), k


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.77])
def test_layerwise_mask_matches_jax(p):
    imp = importances(3)
    want = jmasks.layerwise_mask({k: jnp.asarray(v) for k, v in imp.items()}, p)
    got = tmasks.layerwise_mask({k: torch.from_numpy(v) for k, v in imp.items()}, p)
    check_equal(want, got)


def test_nan_is_kept_and_negative_zero_ranks_as_zero():
    """The bits rule: a NaN ranks above every value (kept at p = 5/6, where
    a float comparison would prune it), and -0.0 ties +0.0."""
    v = torch.tensor([0.0, -0.0, 1.0, float("nan"), 2.0, 3.0])
    m = tmasks.global_mask({"v": v}, 5 / 6)["v"]
    assert m.tolist() == [False, False, False, True, False, False]
    assert float_bits(torch.tensor([-0.0])).item() == 0
    m = tmasks.global_mask({"v": v}, 2 / 6)["v"]
    assert m.tolist() == [False, False, True, True, True, True]


@pytest.mark.parametrize("seed", [0, 4])
def test_global_selection_matches_a_sort_of_the_concatenation(seed):
    imp = importances(seed, specials=False)
    flat = np.concatenate([np.abs(v).reshape(-1) for v in imp.values()])
    order = np.sort(flat)
    bits = [float_bits(torch.from_numpy(v)) for v in imp.values()]
    for k in (0, 1, 7, len(flat) // 2, len(flat) - 1):
        got = kth_smallest_bits(bits, k)
        assert np.array([got], np.int32).view(np.float32)[0] == order[k], k
    with pytest.raises(ValueError):
        kth_smallest_bits(bits, len(flat))


def test_bits_of_nonnegative_float32_are_a_view():
    v = torch.rand(5, 3)
    assert float_bits(v).data_ptr() == v.data_ptr()
    w = -v
    assert float_bits(w).data_ptr() != w.data_ptr()
    assert torch.equal(float_bits(w), float_bits(v))


@pytest.mark.parametrize("iterations", [1, 2, 3, 5])
@pytest.mark.parametrize("target", [0.5, 0.6])
def test_schedule_matches_jax(target, iterations):
    want = jmasks.iterative_sparsity_schedule(target, iterations)
    assert tmasks.iterative_sparsity_schedule(target, iterations) == want
    assert want[-1] == target


def test_schedule_ramps_as_the_reference():
    got = tmasks.iterative_sparsity_schedule(0.5, 3)
    assert [round(x, 3) for x in got] == [0.125, 0.354, 0.5]
