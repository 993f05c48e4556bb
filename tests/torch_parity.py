"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
tiny BLIP-2 and tiny LLaMA in both packages with the same weights, batches
made with numpy from a seed, the JAX noise draws the port's MeZO hook
replays, and both packages' first-order sums on one model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.models.convert import load_jax_params


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module, restored after it. At
    these tiny shapes the threads buy nothing, and when the suite's workers
    share a machine they oversubscribe its cores: a CLI test took 50 s with
    8 threads and 2.8 s with 1 beside a running suite. Use it with
    ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_batch(cfg, n=8, src=6, tgt=5, seed=0, pad_tail=0):
    """numpy calibration batch; ``pad_tail`` label positions are -100."""
    rng = np.random.default_rng(seed)
    img = cfg.vit.img_size
    labels = rng.integers(2, cfg.t5.vocab_size, size=(n, tgt))
    if pad_tail:
        labels[:, tgt - pad_tail:] = -100
    return {
        "image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
        "text_input_ids": rng.integers(2, cfg.t5.vocab_size, size=(n, src)),
        "text_input_mask": np.ones((n, src), np.int64),
        "labels": labels,
    }


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


def tiny_pair(seed=0, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    """(cfg, JAX params, port model with the same weights)."""
    cfg = jblip2.tiny_config()
    params = jblip2.init_params(cfg, jax.random.PRNGKey(seed), jax_dtype)
    model = tblip2.build_model(tblip2.tiny_config(), device="cpu",
                               dtype=torch_dtype, seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def llama_pair(seed=0, **cfg_kw):
    """Tiny LLaMA (``tiny_config(**cfg_kw)``): (cfg, JAX params, port model
    with the same weights), float32."""
    cfg = jllama.tiny_config(**cfg_kw)
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    model = tllama.build_model(tllama.tiny_config(**cfg_kw), device="cpu",
                               dtype=torch.float32, seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def lm_batch(cfg, n=8, seqlen=16, seed=0):
    """numpy LM calibration batch: ``n`` windows of ``seqlen`` token ids."""
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(2, cfg.vocab_size, size=(n, seqlen))}


def jax_noise(key):
    """The port's MeZO noise hook replaying the JAX draws:
    normal(fold_in(fold_in(fold_in(key, target), b), n), (in, out)), transposed
    to (out, in) -- the key chain of ecoflap_tpu/pruning/mezo.py:405,436; in
    ``shared`` mode (b is None) normal(fold_in(fold_in(key, target), n)), the
    chain of both shared paths (mezo.py:373-381, 413)."""

    def noise(ti, b, n, shape):
        k = jax.random.fold_in(key, ti)
        if b is not None:
            k = jax.random.fold_in(k, b)
        k = jax.random.fold_in(k, n)
        z = jax.random.normal(k, (shape[1], shape[0]), jnp.float32)
        return torch.from_numpy(np.asarray(z).T.copy())

    return noise


FIRST_ORDER_METHODS = ("GradOnly", "GradMagAbs", "GradMagSquare")


def first_order_setup(model_name, num_mb=2):
    """(JAX adapter, JAX params, port adapter, numpy batch) of one tiny
    model, ``"blip2"`` or ``"llama"``, for the first-order tests."""
    if model_name == "blip2":
        cfg, params, model = tiny_pair(seed=0)
        batch = np_batch(cfg, n=4 * num_mb, seed=3)
        return jblip2.make_adapter(cfg, params), params, tblip2.make_adapter(model), batch
    cfg, params, model = llama_pair(seed=2)
    batch = lm_batch(cfg, n=4 * num_mb, seqlen=16, seed=7)
    return jllama.make_adapter(cfg, params), params, tllama.make_adapter(model), batch


def first_order_sums(model_name, num_mb=2):
    """Both packages' first-order sums of one tiny model for every method:
    JAX partitioned and streamed, the port with the adapter's plans
    (streamed) and without them (one backward of the whole loss). Returns
    (port adapter, {(package, path, method): sums})."""
    from ecoflap_tpu.pruning.first_order import first_order_group_sums as jsums
    from ecoflap_tpu_torch.pruning.first_order import first_order_group_sums as tsums

    jad, params, tad, batch = first_order_setup(model_name, num_mb)
    jb, tb = to_jax(batch), to_torch(batch)
    batches = [jax.tree_util.tree_map(
        lambda x: x.reshape(num_mb, -1, *x.shape[1:])[b], jb) for b in range(num_mb)]
    prefixes = [s.blocks_path for s in jad.stacks]
    out = {}
    for method in FIRST_ORDER_METHODS:
        out["jax", "partitioned", method] = jsums(
            jad.loss_fn, params, batches, jad.targets(), method,
            partition_prefixes=prefixes)
        out["jax", "streamed", method] = jsums(
            jad.loss_fn, params, batches, jad.targets(), method,
            partition_prefixes=prefixes, stream_plans=jad.build_mezo_plans(params, jb))
        out["port", "streamed", method] = tsums(
            tad.loss_fn, tad.model, tb, num_mb, tad.targets(), method,
            plans=tad.build_mezo_plans(tad.model, tb))
        out["port", "plain", method] = tsums(
            tad.loss_fn, tad.model, tb, num_mb, tad.targets(), method)
    return tad, out


BLIP1_JAX = {  # kind -> (init_params name, per-sample loss name, adapter name)
    "blip_caption": ("init_params", "per_sample_loss", "make_adapter"),
    "blip_vqa": ("init_vqa_params", "vqa_loss", "make_vqa_adapter"),
    "blip_nlvr": ("init_nlvr_params", "nlvr_loss", "make_nlvr_adapter"),
    "blip_retrieval": ("init_retrieval_params", "retrieval_per_sample_loss",
                       "make_retrieval_adapter"),
}
BLIP1_HEADS = {"caption": "blip_caption", "vqa": "blip_vqa", "nlvr": "blip_nlvr",
               "retrieval": "blip_retrieval"}


def blip1_pair(kind, seed=0, kernel_scale=1.0):
    """Tiny BLIP-1 of one head in both packages, float32: (cfg, JAX params,
    port model with the same weights). ``kernel_scale`` multiplies every
    linear kernel of the init (std 0.02), so that a MeZO perturbation moves
    the loss by many float32 ulps."""
    from ecoflap_tpu.models import blip1 as jblip1
    from ecoflap_tpu_torch.models import blip1 as tblip1

    cfg = jblip1.tiny_config()
    params = getattr(jblip1, BLIP1_JAX[kind][0])(cfg, jax.random.PRNGKey(seed))
    if kernel_scale != 1.0:
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: a * kernel_scale
            if getattr(path[-1], "key", None) == "kernel" else a, params)
    model = tblip1.build_model(tblip1.tiny_config(), kind, device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model
