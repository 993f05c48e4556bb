"""The port's SparseGPT (``ecoflap_tpu_torch/pruning/sparsegpt.py``) against
``ecoflap_tpu.pruning.sparsegpt`` on the same float32 inputs, made with numpy
from a seed, and Wanda's n:m mask against the JAX one.

Tolerance: the sweep is float32 on both sides with the same operations in
the same order per column, but the Cholesky factors, the triangular inverse
and the block products come from different libraries (LAPACK through torch,
XLA's own), so entries differ by float32 reduction-order noise that the
sweep carries along its columns: at the largest width here (300 columns)
the measured worst difference is 1.4e-5 on weights of order 1. So weights
within rtol 2e-4 and atol 5e-5, and masks (the zero patterns) equal: a
flipped mask entry would move a weight by O(1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.pruning import sparsegpt as J
from ecoflap_tpu.pruning.wanda import mask_n_m as jmask_n_m
from ecoflap_tpu_torch.pruning import sparsegpt as T
from ecoflap_tpu_torch.pruning.wanda import mask_n_m
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 5e-5


def _hessian(rng, dim, n=256, lanes=None):
    shape = (n, dim) if lanes is None else (lanes, n, dim)
    x = rng.normal(size=shape).astype(np.float32)
    return (2.0 / n) * np.einsum("...ni,...nj->...ij", x, x).astype(np.float32)


def _jax(w, h, sp, **kw):
    return np.asarray(J.sparsegpt_prune_weight(jnp.asarray(w), jnp.asarray(h),
                                               jnp.float32(sp), **kw))


def _port(w, h, sp, **kw):
    return T.sparsegpt_prune_weight(torch.from_numpy(w), torch.from_numpy(h), sp,
                                    **kw).numpy()


def _jax_group(ws, hs, sps, **kw):
    return np.asarray(J.sparsegpt_prune_weight_group(
        jnp.asarray(ws), jnp.asarray(hs), jnp.asarray(sps, jnp.float32), **kw))


def _port_group(ws, hs, sps, **kw):
    return T.sparsegpt_prune_weight_group(torch.from_numpy(ws), torch.from_numpy(hs),
                                          list(sps), **kw).numpy()


def _same(got, want):
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# the shapes of tests/test_sparsegpt.py:81, and 300 columns: two full
# 128-column blocks and a remainder of 44
SHAPES = [(8, 16, 8), (16, 32, 16), (12, 20, 8), (24, 300, 128)]


@pytest.mark.parametrize("rows,cols,blocksize", SHAPES)
@pytest.mark.parametrize("sparsity", [0.3, 0.5])
def test_prune_weight_matches_jax(rows, cols, blocksize, sparsity):
    rng = np.random.default_rng(rows * cols)
    w = rng.normal(size=(rows, cols)).astype(np.float32)
    h = _hessian(rng, cols)
    got = _port(w, h, sparsity, blocksize=blocksize)
    _same(got, _jax(w, h, sparsity, blocksize=blocksize))
    # per 128-column block the mask prunes at least floor(n sp) entries
    assert (got == 0).mean() >= sparsity - 1e-6


@pytest.mark.parametrize("rows,cols,blocksize", SHAPES)
def test_two_four_matches_jax(rows, cols, blocksize):
    """n:m (2:4): the mask is chosen per 4-column group from the updated
    weights as the sweep reaches it (sparsegpt_pruner.py:196-198)."""
    rng = np.random.default_rng(cols)
    w = rng.normal(size=(rows, cols)).astype(np.float32)
    h = _hessian(rng, cols)
    kw = dict(blocksize=blocksize, prune_n=2, prune_m=4)
    got = _port(w, h, 0.0, **kw)
    _same(got, _jax(w, h, 0.0, **kw))
    assert ((got.reshape(rows, cols // 4, 4) == 0).sum(-1) == 2).all()


def test_dead_columns_are_zeroed_as_jax_does():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    h = _hessian(rng, 16)
    h[3, :] = 0
    h[:, 3] = 0
    got = _port(w, h, 0.3)
    assert (got[:, 3] == 0).all()
    _same(got, _jax(w, h, 0.3))


@pytest.mark.parametrize("where", [(0, 1), (2, 2), (5, 7)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_inf_is_clamped_to_the_quantiles_as_jax_does(where, sign):
    """A single +-inf entry of a 40 x 40 Hessian: both packages replace it
    by the 0.999 / 0.001 quantile, which at 1600 entries interpolates
    between finite ones, so the sweep stays finite and equal."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(12, 40)).astype(np.float32)
    h = _hessian(rng, 40)
    h[where] = sign * np.inf
    got, want = _port(w, h, 0.5, blocksize=16), _jax(w, h, 0.5, blocksize=16)
    assert np.isfinite(got).all()
    _same(got, want)
    clamped = T._clamp_infs(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(clamped, np.asarray(J._clamp_infs(jnp.asarray(h))))


def test_clamp_leaves_a_finite_matrix_alone():
    h = torch.randn(6, 6)
    assert T._clamp_infs(h) is h


def test_cholesky_damps_cumulatively_as_jax_does():
    """An indefinite matrix: the factor succeeds only after some damping
    tries, each adding ``damp`` to the diagonal again; both packages end on
    the same matrix and so on the same factor. A NaN matrix never succeeds:
    NaN in both."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(10, 10)).astype(np.float32)
    h = (a + a.T) / 2  # indefinite
    damp = np.float32(0.7)
    want = np.asarray(J.robust_cholesky(jnp.asarray(h), jnp.float32(damp)))
    got = T.robust_cholesky(torch.from_numpy(h), torch.tensor(damp)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    h[2, 4] = h[4, 2] = np.nan
    nan_chol = T.robust_cholesky(torch.from_numpy(h), torch.tensor(damp), max_tries=3)
    assert torch.isnan(nan_chol).all()


def test_prepare_hinv_matches_jax():
    rng = np.random.default_rng(4)
    h = _hessian(rng, 24)
    h[5, :] = h[:, 5] = 0  # a dead column
    want_u, want_dead = J.prepare_hinv(jnp.asarray(h))
    got_u, got_dead = T.prepare_hinv(torch.from_numpy(h))
    np.testing.assert_array_equal(got_dead.numpy(), np.asarray(want_dead))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-4, atol=1e-6)
    assert np.allclose(np.tril(got_u.numpy(), -1), 0)  # upper factor


def test_group_sweep_matches_jax_and_the_serial_sweep():
    """Four lanes of (24, 40) with their own ratios: the batched sweep gives
    each lane what the serial sweep gives it (same operations, only the
    batched products' reduction order differs), and what JAX's group gives."""
    rng = np.random.default_rng(0)
    k, rows, cols = 4, 24, 40
    ws = rng.normal(size=(k, rows, cols)).astype(np.float32)
    hs = _hessian(rng, cols, n=64, lanes=k)
    sps = [0.3, 0.5, 0.6, 0.45]
    grouped = _port_group(ws, hs, sps, blocksize=16)
    _same(grouped, _jax_group(ws, hs, sps, blocksize=16))
    for i in range(k):
        _same(grouped[i], _port(ws[i], hs[i], sps[i], blocksize=16))


@pytest.mark.parametrize("bad", ["inf", "nan"])
def test_a_failed_lane_leaves_the_other_lanes_exact(bad):
    """tests/test_sparsegpt.py:195's case and its NaN twin: lane 0's Hessian
    holds an inf (clamped, but to an inf quantile at this size) or a
    symmetric NaN, so its factorisation fails after every damping try. Lane
    0 comes out as JAX's does (unstructured: all zero, since a NaN threshold
    prunes everything; 2:4: the pattern with NaN kept weights), and lane 1
    equals its serial sweep and JAX's, finite."""
    rng = np.random.default_rng(1)
    k, rows, cols = 2, 8, 16
    ws = rng.normal(size=(k, rows, cols)).astype(np.float32)
    hs = _hessian(rng, cols, n=32, lanes=k)
    if bad == "inf":
        hs[0, 0, 1] = np.inf
    else:
        hs[0, 3, 5] = hs[0, 5, 3] = np.nan
    for kw in (dict(blocksize=8), dict(blocksize=8, prune_n=2, prune_m=4)):
        got = _port_group(ws, hs, [0.5, 0.5], **kw)
        want = _jax_group(ws, hs, [0.5, 0.5], **kw)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        _same(np.nan_to_num(got[0], nan=7.0), np.nan_to_num(want[0], nan=7.0))
        assert np.isfinite(got[1]).all()
        _same(got[1], want[1])
        _same(got[1], _port(ws[1], hs[1], 0.5, **kw))
    assert (got[0].reshape(rows, cols // 4, 4) == 0).sum(-1).min() == 2


def test_accumulate_hessian_matches_jax():
    rng = np.random.default_rng(3)
    batches = [rng.normal(size=(4, 5, 8)).astype(np.float32) for _ in range(3)]
    h, n = torch.zeros(8, 8), 0.0
    jh, jn = jnp.zeros((8, 8), jnp.float32), jnp.zeros((), jnp.float32)
    for b in batches:
        h, n = T.accumulate_hessian(h, n, torch.from_numpy(b))
        jh, jn = J.accumulate_hessian(jh, jn, jnp.asarray(b))
    assert n == float(jn) == 12
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    # the fine stage's form: (2 / n) times the raw sum of X^T X
    x = np.concatenate([b.reshape(-1, 8) for b in batches])
    np.testing.assert_allclose(h.numpy(), (2.0 / 12) * (x.T @ x), rtol=1e-5, atol=1e-6)


def test_wanda_mask_n_m_matches_jax():
    rng = np.random.default_rng(5)
    metric = rng.random(size=(6, 16)).astype(np.float32)
    metric[0, :4] = 0.5  # a tie: broken by position in both
    for n, m in ((2, 4), (4, 8), (1, 2)):
        got = mask_n_m(torch.from_numpy(metric), n, m).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmask_n_m(jnp.asarray(metric), n, m)))
        assert (got.reshape(6, -1, m).sum(-1) == n).all()
    with pytest.raises(ValueError):
        mask_n_m(torch.from_numpy(metric[:, :15]), 2, 4)
