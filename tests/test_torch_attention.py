"""The port's attention (``ecoflap_tpu_torch/ops/attention.py``) against the
JAX package's ``mha`` in each mode, its mode resolution, and the flash
kernels' wrappers on the CPU, forward and backward.

The JAX flash path is TPU-only (tests/test_attention.py:102-104), so the JAX
reference for the function the flash kernel computes is ``mha`` in
``chunked`` and ``naive`` mode: causal softmax(Q Kᵀ · sm_scale) V.

Tolerances, float32: the two packages sum the same products in other orders
(BLAS vs XLA), a few float32 ulps on outputs of size ~1: rtol 1e-5, atol
1e-6. The flash plain version scales the float32 scores where ``chunked``
scales q first, one more rounding per score: atol 1e-5 at Dh = 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.ops import attention as JA
from ecoflap_tpu_torch.models.layers import attention as layers_attention
from ecoflap_tpu_torch.ops import attention as TA

RTOL, ATOL = 1e-5, 1e-6


def _qkv(seed, b, h, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, sq, dh), (b, h, sk, dh), (b, h, sk, dh)))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["naive", "chunked"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_mha_matches_jax_in_each_mode(mode, causal, with_bias):
    """tests/test_attention.py:27-38, port vs JAX mode for mode."""
    arrays = _qkv(0, 2, 3, 64, 64, 16)
    if with_bias:
        arrays += (np.random.default_rng(9).normal(size=(1, 1, 64, 64)).astype(np.float32),)
    (jq, jk, jv, *jb), (tq, tk, tv, *tb) = _both(arrays)
    want = JA.mha(jq, jk, jv, sm_scale=0.25, bias=jb[0] if jb else None,
                  causal=causal, mode=mode, kv_chunk=16)
    got = TA.mha(tq, tk, tv, sm_scale=0.25, bias=tb[0] if tb else None,
                 causal=causal, mode=mode, kv_chunk=16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["naive", "chunked"])
def test_cross_attention_with_batched_bias_matches_jax(mode):
    """Sq != Sk and a per-batch, per-head bias (tests/test_attention.py:41-48)."""
    arrays = _qkv(1, 2, 4, 48, 96, 8)
    arrays += (np.random.default_rng(2).normal(size=(2, 4, 48, 96)).astype(np.float32),)
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(arrays)
    want = JA.mha(jq, jk, jv, sm_scale=1.0, bias=jb, mode=mode, kv_chunk=32)
    got = TA.mha(tq, tk, tv, sm_scale=1.0, bias=tb, mode=mode, kv_chunk=32)
    _close(got, want)


def test_chunked_ragged_tail_falls_back_to_naive_as_jax_does():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 2, 33, 33, 8))
    want = JA.mha(jq, jk, jv, sm_scale=1.0, causal=True, mode="chunked", kv_chunk=16)
    got = TA.mha(tq, tk, tv, sm_scale=1.0, causal=True, mode="chunked", kv_chunk=16)
    _close(got, want)
    naive = TA.mha(tq, tk, tv, sm_scale=1.0, causal=True, mode="naive")
    assert torch.equal(got, naive)


def test_naive_is_bit_identical_to_the_models_attention():
    """``models/layers.py:attention`` (merged heads, the BLIP-2 towers') is
    ``mha`` in naive mode bit for bit, as in the JAX package
    (attention.py:92-108): its head split and merge add no rounding."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 4, 24, 24, 8))
    bias = torch.from_numpy(
        np.random.default_rng(5).normal(size=(2, 1, 1, 24)).astype(np.float32))

    def merge(t):
        return t.transpose(1, 2).reshape(2, 24, 32)

    want = layers_attention(merge(q), merge(k), merge(v), 4, scale=0.3, bias=bias)
    got = TA.mha(q, k, v, sm_scale=0.3, bias=bias, mode="naive")
    assert torch.equal(merge(got), want)


def test_chunked_bf16_close_to_naive_f32():
    """tests/test_attention.py:59-65 on the port."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 64, 64, 16))
    ref = TA.mha(q, k, v, sm_scale=0.25, causal=True, mode="naive")
    out = TA.mha(*(t.to(torch.bfloat16) for t in (q, k, v)), sm_scale=0.25,
                 causal=True, mode="chunked", kv_chunk=16)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.05, rtol=0.05)


@pytest.mark.parametrize("mode", ["flash_ref", "flash_mode"])
def test_flash_function_matches_jax_chunked_causal(mode):
    """The flash kernel's function at (1, 2, 512, 128) in float32, through
    its plain version and through ``mha(mode="flash")`` on the CPU."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 1, 2, 512, 512, 128))
    scale = 128 ** -0.5
    want = JA.mha(jq, jk, jv, sm_scale=scale, causal=True, mode="chunked")
    if mode == "flash_ref":
        got = TA.flash_attention_ref(tq, tk, tv, scale)
    else:
        got = TA.mha(tq, tk, tv, sm_scale=scale, causal=True, mode="flash")
    _close(got, want, atol=1e-5)
    _close(got, JA.mha(jq, jk, jv, sm_scale=scale, causal=True, mode="naive"),
           atol=1e-5)


def test_flash_plain_version_is_causal_and_rounds_once():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 2, 128, 128, 128))
    out = TA.flash_attention_ref(q, k, v, 0.1)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] += 3.0
    v2[:, :, 100:] -= 3.0
    out2 = TA.flash_attention_ref(q, k2, v2, 0.1)
    assert torch.equal(out[:, :, :100], out2[:, :, :100])
    assert not torch.equal(out[:, :, 100:], out2[:, :, 100:])
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ob = TA.flash_attention_ref(qb, kb, vb, 0.1)
    assert ob.dtype == torch.bfloat16
    want = TA.flash_attention_ref(qb.float(), kb.float(), vb.float(), 0.1)
    assert torch.equal(ob, want.to(torch.bfloat16))


def test_resolve_mode_auto_on_the_cpu():
    """tests/test_attention.py:68-75; a CPU tensor never resolves to flash,
    even at a flash-eligible bf16 shape."""
    small = torch.zeros(1, 1, 64, 8)
    assert TA.resolve_mode(small, small, True, None) == "naive"
    long = torch.zeros(1, 1, 1024, 8)
    assert TA.resolve_mode(long, long, True, None) == "chunked"
    assert TA.resolve_mode(small[:, :, :1], long, False, None) == "naive"
    eligible = torch.zeros(1, 2, 2048, 128, dtype=torch.bfloat16)
    assert TA._flash_eligible(eligible, eligible, True, None)
    assert TA.resolve_mode(eligible, eligible, True, None) == "chunked"


def test_flash_eligibility_rules_match_jax():
    """tests/test_attention.py:78-86 on both packages' rules."""
    shapes = [((1, 2, 2048, 128), (1, 2, 2048, 128)), ((1, 2, 2048, 96),) * 2,
              ((1, 2, 1000, 128),) * 2, ((1, 2, 512, 128), (1, 2, 1024, 128))]
    for qs, ks in shapes:
        for causal in (False, True):
            for bias in (None, np.zeros(1, np.float32)):
                want = JA._flash_eligible(jnp.zeros(qs), jnp.zeros(ks), causal,
                                          None if bias is None else jnp.asarray(bias))
                got = TA._flash_eligible(torch.zeros(qs), torch.zeros(ks), causal,
                                         None if bias is None else torch.from_numpy(bias))
                assert got == want, (qs, ks, causal, bias)
    q = torch.zeros(1, 2, 2048, 128)
    with pytest.raises(ValueError, match="flash"):
        TA.mha(q, q, q, causal=False, mode="flash")


def test_forced_flash_env_raises_when_ineligible(monkeypatch):
    """A path is forced only through ``mode=``: a forced ``flash`` on an
    ineligible shape raises, and the JAX package's ``ECOFLAP_ATTN`` steers
    nothing in the port (resolution reads device, dtype and shapes only)."""
    q = torch.zeros(1, 2, 64, 8)
    with pytest.raises(ValueError, match="flash"):
        TA.mha(q, q, q, causal=True, mode="flash")
    eligible = torch.zeros(1, 1, 1024, 128, dtype=torch.bfloat16)
    for forced in ("flash", "naive"):
        monkeypatch.setenv("ECOFLAP_ATTN", forced)
        assert TA.resolve_mode(eligible, eligible, True, None) == "chunked"
        assert TA.resolve_mode(q, q, True, None) == "naive"


def test_flash_on_a_cpu_tensor_takes_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 2, 64, 64, 128))
    before = TA.flash_attention.launches
    got = TA.flash_attention(q, k, v, 0.125)
    assert torch.equal(got, TA.flash_attention_ref(q, k, v, 0.125))
    assert TA.flash_attention.launches == before


def test_flash_rejects_grad_and_mismatched_inputs():
    """Mismatched inputs raise; an input that requires grad is served (the
    backward is ported), and on the CPU it takes the plain versions without
    counting a launch."""
    q = torch.zeros(1, 2, 64, 128, requires_grad=True)
    k = torch.zeros(1, 2, 64, 128)
    before = (TA.flash_attention.launches, TA.flash_attention_bwd.launches)
    TA.flash_attention(q, k, k, 1.0).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert (TA.flash_attention.launches, TA.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="sq == sk"):
        TA.flash_attention(k, torch.zeros(1, 2, 128, 128), torch.zeros(1, 2, 128, 128), 1.0)
    with pytest.raises(TypeError):
        TA.flash_attention(k, k.double(), k, 1.0)
    with pytest.raises(ValueError):
        TA.flash_attention(k[0], k[0], k[0], 1.0)
    with pytest.raises(ValueError, match="lse"):
        TA.flash_attention_bwd(k, k, k, k, torch.zeros(1, 2, 32), k, 1.0)


# -- the backward ---------------------------------------------------------------
#
# Tolerance, float32 at (1, 2, 512, 128): the two packages form the same
# float32 products in other orders, and the JAX modes scale q before the
# scores where the port scales the scores; each gradient sums 512 such
# terms of size ~1, so a few float32 ulps of sums of size ~10: atol 1e-5.
BWD_SHAPE = (1, 2, 512, 128)
BWD_ATOL = 1e-5


def _bwd_inputs(seed):
    q, k, v = _qkv(seed, *BWD_SHAPE[:3], BWD_SHAPE[2], BWD_SHAPE[3])
    do = np.random.default_rng(seed + 100).normal(size=BWD_SHAPE).astype(np.float32)
    return q, k, v, do


def _port_grads(path, q, k, v, do, scale):
    tq, tk, tv, tdo = (torch.from_numpy(a.copy()) for a in (q, k, v, do))
    if path == "plain":
        o, lse = TA.flash_attention_lse_ref(tq, tk, tv, scale)
        return TA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, scale)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = TA.mha(*leaves, sm_scale=scale, causal=True, mode="flash")
    return torch.autograd.grad(out, leaves, grad_outputs=tdo)


@pytest.mark.parametrize("jax_mode", ["chunked", "naive"])
@pytest.mark.parametrize("path", ["plain", "autograd_function"])
def test_flash_backward_matches_jax_vjp_of_mha(path, jax_mode):
    """dq, dk, dv of the backward's plain version, and of the autograd
    Function that ``mha(mode="flash")`` runs on CPU tensors, against
    ``jax.vjp`` of the JAX package's ``mha`` on the same inputs and dO."""
    import jax

    q, k, v, do = _bwd_inputs(11)
    scale = BWD_SHAPE[3] ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: JA.mha(a, b, c, sm_scale=scale, causal=True,
                                            mode=jax_mode),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _port_grads(path, q, k, v, do, scale)
    for g, w in zip(got, want):
        _close(g, w, atol=BWD_ATOL)


def test_flash_backward_matches_the_pallas_libraries_reference_bwd():
    """The plain backward against the Pallas library's own pure-jnp
    ``mha_reference_bwd`` (jax/experimental/pallas/ops/tpu/flash_attention.py),
    the backward that the TPU kernels are tested against, and the LSE
    against the library's residuals, m + log l. That reference takes
    sm_scale == 1 only, so q enters pre-scaled."""
    from jax.experimental.pallas.ops.tpu import flash_attention as lib

    q, k, v, do = _bwd_inputs(12)
    q = (q * BWD_SHAPE[3] ** -0.5).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, l, m = lib.mha_reference_no_custom_vjp(jq, jk, jv, causal=True,
                                                save_residuals=True)
    want = lib.mha_reference_bwd(jq, jk, jv, None, None, out, l, m, jdo, causal=True)[:3]
    tq, tk, tv, tdo = (torch.from_numpy(a.copy()) for a in (q, k, v, do))
    o, lse = TA.flash_attention_lse_ref(tq, tk, tv, 1.0)
    _close(o, out)
    _close(lse, m + jnp.log(l))
    for g, w in zip(TA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, 1.0), want):
        _close(g, w, atol=BWD_ATOL)


def test_flash_backward_agrees_with_autograd_through_the_plain_forward():
    """The explicit formulas of the plain backward, and the autograd
    Function, against autograd through ``flash_attention_ref`` (softmax's
    own backward) on the same float32 inputs: the same function, other
    float32 roundings (rowsum(O ∘ dO) against rowsum(P ∘ dP))."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(13))
    scale = 0.1
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TA.flash_attention_ref(*leaves, scale), leaves,
                               grad_outputs=do)
    o, lse = TA.flash_attention_lse_ref(q, k, v, scale)
    for g, w in zip(TA.flash_attention_bwd_ref(q, k, v, o, lse, do, scale), want):
        _close(g, w, atol=BWD_ATOL)
    fn = torch.autograd.grad(TA.flash_attention(*leaves, scale), leaves, grad_outputs=do)
    for g, w in zip(fn, want):
        _close(g, w, atol=BWD_ATOL)


def test_flash_backward_is_causal():
    """dO zero on query rows >= r: key rows >= r get no gradient, exactly
    (those keys are seen only by those queries)."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(14))
    r = 300
    do[:, :, r:] = 0
    o, lse = TA.flash_attention_lse_ref(q, k, v, 0.1)
    dq, dk, dv = TA.flash_attention_bwd_ref(q, k, v, o, lse, do, 0.1)
    assert torch.count_nonzero(dk[:, :, r:]) == 0
    assert torch.count_nonzero(dv[:, :, r:]) == 0
    assert torch.count_nonzero(dq[:, :, r:]) == 0
    assert torch.count_nonzero(dk[:, :, :r]) > 0
