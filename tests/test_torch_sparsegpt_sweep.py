"""SparseGPT's in-block sweep as the pruning code calls it
(``pruning/sparsegpt.py:_sweep_block_``) and the kernel's wrapper
(``ops/sparsegpt_sweep.py``), on the CPU: the wrapper's checks refuse what
the kernel does not take before any device is asked for, it refuses a CPU
tensor without counting a launch, and a CPU block takes the plain version
in place, as the kernel does on the card. The kernel itself runs only on
the card (``chip_smoke.py`` phases 2 and 3 hold it against ``_sweep_block``
bit for bit)."""

import pytest
import torch

from ecoflap_tpu_torch.ops import sparsegpt_sweep as S
from ecoflap_tpu_torch.pruning import sparsegpt as sg
from ecoflap_tpu_torch.utils.profiling import recording
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, ROWS, COLS = 2, 6, 40


def _inputs(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(K, ROWS, COLS, generator=g, dtype=dtype)
    x = torch.randn(K, 64, COLS, generator=g, dtype=dtype)
    hinv, _ = sg.prepare_hinv((2.0 / 64) * x.mT @ x)
    return w, hinv.contiguous()


def _block(w, hinv, i1=8, i2=24):
    w1, hinv1 = w[..., i1:i2], hinv[:, i1:i2, i1:i2]
    sal = w1 ** 2 / torch.diagonal(hinv1, dim1=-2, dim2=-1)[:, None, :] ** 2
    mask1 = torch.stack([sg._mask_per_tensor(sal[j], 0.5) for j in range(K)])
    return w1, hinv1, mask1


def _bad_args(bad):
    """(w1, hinv1, mask1, prune_n, prune_m) of one block, spoiled as ``bad``
    says."""
    w, hinv = _inputs()
    w1, hinv1, mask1 = _block(w, hinv)
    n = m = 0
    if bad == "block_over_128":
        w = torch.randn(1, 4, 160)
        hinv = torch.eye(160)[None]
        w1, hinv1, mask1 = w[..., :129], hinv[:, :129, :129], torch.zeros(1, 4, 129, dtype=torch.bool)
    elif bad in ("bfloat16", "float16"):
        w1, hinv1 = w1.to(getattr(torch, bad)), hinv1.to(getattr(torch, bad))
    elif bad == "hinv_dtype":
        hinv1 = hinv1.double()
    elif bad == "w_column_stride":
        w1 = w1.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "hinv_column_stride":
        hinv1 = hinv1.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "hinv_shape":
        hinv1 = hinv1[:, :-1, :-1]
    elif bad == "two_dims":
        w1, mask1 = w1[0], mask1[0]
    elif bad == "no_mask":
        mask1 = None
    elif bad == "mask_dtype":
        mask1 = mask1.to(torch.uint8)
    elif bad == "mask_strided":
        mask1 = mask1.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "mask_with_n_m":
        n, m = 2, 4
    elif bad == "m_over_32":
        w = torch.randn(1, 4, 128)
        hinv = torch.eye(128)[None]
        w1, hinv1, mask1, n, m = w, hinv, None, 32, 64
    elif bad == "m_not_dividing_the_block":
        w1, mask1, n, m = w1[..., :15], None, 2, 4
        hinv1 = hinv1[:, :15, :15]
    elif bad == "negative_n":
        mask1, n, m = None, -1, 4
    return w1, hinv1, mask1, n, m


BAD = ["block_over_128", "bfloat16", "float16", "hinv_dtype", "w_column_stride",
       "hinv_column_stride", "hinv_shape", "two_dims", "no_mask", "mask_dtype",
       "mask_strided", "mask_with_n_m", "m_over_32", "m_not_dividing_the_block",
       "negative_n"]


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Each refusal comes from the checks, before the wrapper asks for a
    card: the same error through ``check`` and through the wrapper on CPU
    tensors, and no launch counted."""
    args = _bad_args(bad)
    with pytest.raises((TypeError, ValueError)) as direct:
        S.check(*args)
    assert "CUDA device" not in str(direct.value)
    before = S.sparsegpt_sweep.launches
    with pytest.raises(type(direct.value), match="sparsegpt_sweep"):
        S.sparsegpt_sweep(*args)
    assert S.sparsegpt_sweep.launches == before


@pytest.mark.parametrize("nm", [(0, 0), (2, 4)])
def test_wrapper_takes_a_valid_block_only_on_the_card(nm):
    w, hinv = _inputs()
    w1, hinv1, mask1 = _block(w, hinv)
    if nm[0]:
        mask1 = None
    S.check(w1, hinv1, mask1, *nm)  # a block the kernel takes
    before = S.sparsegpt_sweep.launches
    with pytest.raises(ValueError, match="CUDA device"):
        S.sparsegpt_sweep(w1, hinv1, mask1, *nm)
    assert S.sparsegpt_sweep.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nm", [(0, 0), (2, 4)])
def test_a_cpu_block_is_swept_in_place_by_the_plain_version(nm, dtype):
    """``_sweep_block_`` on a CPU view of a wider weight: the block's
    columns become ``_sweep_block``'s Q1 and the result is its Err1, bit for
    bit; the other columns are untouched, and no kernel launch is made or
    counted."""
    w, hinv = _inputs(seed=1, dtype=dtype)
    w1, hinv1, mask1 = _block(w, hinv)
    q1, err1 = sg._sweep_block(w1.clone(), hinv1, mask1.clone() if not nm[0]
                               else torch.zeros(w1.shape, dtype=torch.bool), *nm)
    got = w.clone()
    before = S.sparsegpt_sweep.launches
    with recording(torch.device("cpu")) as rec:
        err = sg._sweep_block_(got[..., 8:24], hinv1, None if nm[0] else mask1, *nm)
    assert torch.equal(got[..., 8:24], q1) and torch.equal(err, err1)
    assert torch.equal(got[..., :8], w[..., :8]) and torch.equal(got[..., 24:], w[..., 24:])
    if nm[0]:
        assert ((got[..., 8:24].reshape(K, ROWS, 4, 4) == 0).sum(-1) >= 2).all()
    assert S.sparsegpt_sweep.launches == before and rec.counts == {}
