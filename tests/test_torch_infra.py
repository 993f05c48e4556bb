"""The port's infrastructure against the JAX package's (mirrors
tests/test_infra.py): LR schedules at every step, the optimizer's decay
mask, the loaders, the metric logger (synced over 2 gloo ranks), the
checkpoints and the training runners; the train processors and
RandAugment bit for bit; and the prune CLI's ``--stacks`` against the JAX
CLI's. Spans, counters and traces are in test_torch_profiling.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecoflap_tpu.core import optims as joptims
from ecoflap_tpu.data import loaders as jloaders
from ecoflap_tpu.data import processors as jproc
from ecoflap_tpu.data import randaugment as jra
from ecoflap_tpu.utils import logger as jlogger
from ecoflap_tpu_torch.core import optims as toptims
from ecoflap_tpu_torch.data import loaders as tloaders
from ecoflap_tpu_torch.data import processors as tproc
from ecoflap_tpu_torch.data import randaugment as tra
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.runners.runner import IterTrainRunner, Runner, TrainRunner
from ecoflap_tpu_torch.utils import logger as tlogger
from tests.torch_dist import run_ranks
from tests.torch_parity import jax_noise, one_torch_thread, tiny_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kw", [
    dict(init_lr=1e-4, min_lr=1e-6, warmup_steps=10, decay_steps=110),
    dict(init_lr=3e-4, min_lr=0.0, warmup_steps=0, decay_steps=60, warmup_start_lr=1e-6),
    dict(init_lr=1e-5, min_lr=1e-7, warmup_steps=25, decay_steps=80, warmup_start_lr=2e-6),
])
def test_cosine_schedule_equals_the_jax_one_at_every_step(kw):
    j, t = joptims.linear_warmup_cosine_lr(**kw), toptims.linear_warmup_cosine_lr(**kw)
    for step in range(100):
        assert abs(t(step) - float(j(step))) < 1e-7, step


@pytest.mark.parametrize("kw", [
    dict(init_lr=1e-3, min_lr=1e-5, warmup_steps=5, decay_rate=0.1, steps_per_epoch=10),
    dict(init_lr=1e-4, min_lr=1e-6, warmup_steps=0, decay_rate=0.5, steps_per_epoch=7),
])
def test_step_schedule_equals_the_jax_one_at_every_step(kw):
    j, t = joptims.linear_warmup_step_lr(**kw), toptims.linear_warmup_step_lr(**kw)
    for step in range(100):
        assert abs(t(step) - float(j(step))) < 1e-7, step


def test_schedules_are_registered():
    from ecoflap_tpu_torch.core.registry import registry

    assert registry.get_lr_scheduler_class("linear_warmup_cosine_lr") is \
        toptims.linear_warmup_cosine_lr
    assert registry.get_lr_scheduler_class("linear_warmup_step_lr") is \
        toptims.linear_warmup_step_lr


def test_optimizer_decay_mask_and_steps_as_optax():
    """No decay on 1-D parameters (test_infra.py:40-49); with gradients, 3
    steps under a schedule equal optax's masked adamw."""
    w0 = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    b0 = np.ones(4, np.float32)
    lin = torch.nn.Linear(4, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
        lin.bias.copy_(torch.from_numpy(b0))
    sched = joptims.linear_warmup_cosine_lr(init_lr=1e-2, min_lr=1e-4, warmup_steps=2,
                                            decay_steps=10)
    opt, lr = toptims.make_optimizer(lin.parameters(),
                                     toptims.linear_warmup_cosine_lr(
                                         init_lr=1e-2, min_lr=1e-4, warmup_steps=2,
                                         decay_steps=10), weight_decay=0.5)
    jopt = joptims.make_optimizer(sched, weight_decay=0.5)
    params = {"w": jnp.asarray(w0.T), "b": jnp.asarray(b0)}
    state = jopt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(3):
        gw = rng.normal(size=(4, 4)).astype(np.float32)
        gb = np.zeros(4, np.float32)
        lin.weight.grad = torch.from_numpy(gw.copy())
        lin.bias.grad = torch.from_numpy(gb.copy())
        opt.step()
        lr.step()
        upd, state = jopt.update({"w": jnp.asarray(gw.T), "b": jnp.asarray(gb)}, state,
                                 params)
        params = optax.apply_updates(params, upd)
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(params["w"]).T,
                               rtol=1e-5, atol=1e-6)
    # zero gradients: only weight decay moves a weight, and the bias is 1-D
    np.testing.assert_array_equal(lin.bias.detach().numpy(), b0)
    np.testing.assert_array_equal(np.asarray(params["b"]), b0)


def test_iter_loader_resets():
    loader = tloaders.IterLoader(lambda: iter([1, 2, 3]))
    assert [next(loader) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]
    assert loader.epoch == 2


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_multi_iter_loader_draws_as_the_jax_one(seed):
    def loaders(mod):
        return [mod.IterLoader(lambda c=c: iter([c])) for c in "abc"]

    j = jloaders.MultiIterLoader(loaders(jloaders), ratios=[6, 3, 1], seed=seed)
    t = tloaders.MultiIterLoader(loaders(tloaders), ratios=[6, 3, 1], seed=seed)
    draws = [next(t) for _ in range(300)]
    assert draws == [next(j) for _ in range(300)]
    assert draws.count("a") > draws.count("b") > draws.count("c")


def test_prefetch_loader_order_on_the_cpu():
    pl = tloaders.PrefetchLoader([{"x": np.asarray([i])} for i in range(5)])
    out = list(pl)
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_metric_logger_strings_are_the_jax_ones():
    j, t = jlogger.MetricLogger(), tlogger.MetricLogger()
    for v, w in [(1.0, 0.5), (2.0, 0.25), (3.0, 4.0)]:
        j.update(loss=v, acc=w)
        t.update(loss=v, acc=w)
    assert str(t) == str(j)
    assert abs(t.meters["loss"].global_avg - 2.0) < 1e-9
    js, ts = jlogger.SmoothedValue(window_size=2), tlogger.SmoothedValue(window_size=2)
    for v in (1.0, 5.0, 2.0):
        js.update(v)
        ts.update(v)
    assert (ts.avg, ts.median, ts.global_avg, ts.value, str(ts)) == (
        js.avg, js.median, js.global_avg, js.value, str(js))


def test_smoothed_value_syncs_over_two_gloo_ranks(tmp_path):
    """LAVIS's all-reduce of count and total (logger.py:43-55): every rank
    reads the global mean; the window stays each rank's own."""
    values = [[1.0, 2.0, 3.0], [10.0, 20.0]]
    res = run_ranks("smoothed_value_sync", 2, {"values": values}, tmp_path)
    flat = [v for vs in values for v in vs]
    for r, vs in zip(res, values):
        assert r["count"] == len(flat) and r["total"] == pytest.approx(sum(flat))
        assert r["global_avg"] == pytest.approx(np.mean(flat))
        assert r["avg"] == pytest.approx(np.mean(vs))
        assert r["logger_global"] == pytest.approx((values[0][0] + values[1][0]) / 2)


def test_runner_checkpoint_roundtrip(tmp_path):
    r = Runner(str(tmp_path), "ck")
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}, "epoch": 3}
    path = r.save_checkpoint(state, "ckpt")
    assert path.endswith("ckpt.pth")
    back = r.load_checkpoint("ckpt")
    assert torch.equal(back["a"], state["a"]) and torch.equal(back["b"]["c"], state["b"]["c"])
    assert back["epoch"] == 3
    quiet = Runner(str(tmp_path / "other"), "ck", write=False)
    assert quiet.save_checkpoint(state, "x").endswith("x.pth")
    assert not (tmp_path / "other").exists()


def _llama(seed=0):
    return tllama.build_model(tllama.tiny_config(), device="cpu", seed=seed)


def _loss(m, b):
    return m.per_sample_loss(b["input_ids"])


def _ids(n, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(2, 64, size=(n, s)))


def test_train_runner_best_checkpoint(tmp_path):
    model = _llama()
    ids = _ids(8, 10)
    with torch.no_grad():
        l0 = float(_loss(model, {"input_ids": ids}).mean())
    r = TrainRunner(str(tmp_path), "train", max_epoch=2)
    best = r.train(_loss, model, lambda e: [{"input_ids": ids}] * 3,
                   optimizer=torch.optim.Adam(model.parameters(), lr=1e-2))
    assert r.best_epoch >= 0 and (tmp_path / "checkpoint_best.pth").exists()
    assert (tmp_path / "train_state.pth").exists()
    with torch.no_grad():
        l1 = float(_loss(model, {"input_ids": ids}).mean())
    assert l1 < l0
    assert all(torch.equal(best[k], v) for k, v in model.state_dict().items())
    assert not any(p.requires_grad for p in model.parameters())


def test_train_runner_logs_the_jax_runners_losses(tmp_path):
    """On the same tiny LLaMA weights and batches, with Adam(1e-2), the
    port's epoch train losses are the JAX TrainRunner's."""
    from ecoflap_tpu.models import llama as jllama
    from ecoflap_tpu.runners.runner import TrainRunner as JTrainRunner
    from tests.torch_parity import llama_pair

    cfg, params, model = llama_pair(seed=0)
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(4, 8))
    JTrainRunner(str(tmp_path / "j"), "j", max_epoch=2).train(
        lambda p, b: jllama.per_sample_loss(cfg, p, b["input_ids"]), params,
        lambda e: [{"input_ids": jnp.asarray(ids, jnp.int32)}] * 2,
        optimizer=optax.adam(1e-2))
    TrainRunner(str(tmp_path / "t"), "t", max_epoch=2).train(
        _loss, model, lambda e: [{"input_ids": torch.from_numpy(ids)}] * 2,
        optimizer=torch.optim.Adam(model.parameters(), lr=1e-2))

    def train_losses(d):
        lines = [json.loads(x) for x in (tmp_path / d / "evaluate.txt").read_text().splitlines()]
        return [v["train_loss"] for x in lines for k, v in x.items() if k == "train"]

    np.testing.assert_allclose(train_losses("t"), train_losses("j"), rtol=1e-5)


def test_iter_train_runner(tmp_path):
    from ecoflap_tpu_torch.data.loaders import IterLoader

    model = _llama()
    ids = _ids(4, 8)
    with torch.no_grad():
        l0 = float(_loss(model, {"input_ids": ids}).mean())
    loader = IterLoader(lambda: iter([{"input_ids": ids}] * 2))
    r = IterTrainRunner(str(tmp_path), "it", max_iters=6, iters_per_inner_epoch=3)
    assert r.max_epoch == 2
    r.train_iters(_loss, model, loader,
                  optimizer=torch.optim.Adam(model.parameters(), lr=1e-2))
    assert r.best_epoch >= 0 and loader.epoch >= 2
    with torch.no_grad():
        assert float(_loss(model, {"input_ids": ids}).mean()) < l0


def test_train_runner_resume_restores_optimizer_and_epoch(tmp_path):
    """Three epochs straight, or one then a resume for two more, give the
    same weights (runner_base.py:897-967): the optimizer state and the epoch
    come back from the train state."""
    batches = {e: [{"input_ids": _ids(4, 8, seed=e)}] for e in range(3)}

    def run(root, max_epoch, model, resume=False):
        r = TrainRunner(str(root), "r", max_epoch=max_epoch)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        return r, r.train(_loss, model, lambda e: batches[e], optimizer=opt, resume=resume)

    ra, best_a = run(tmp_path / "a", 3, _llama())
    rb, _ = run(tmp_path / "b", 1, _llama())
    state = rb.load_checkpoint("train_state")
    assert state["epoch"] == 0 and state["optimizer"]["state"]
    rb2, best_b = run(tmp_path / "b", 3, _llama(seed=9), resume=True)  # weights restored
    assert rb2.best_epoch == ra.best_epoch
    for k in best_a:
        torch.testing.assert_close(best_b[k], best_a[k], rtol=1e-6, atol=1e-6)


def test_train_runner_split_aware_evaluation(tmp_path):
    """The best checkpoint keys on the "val" split only; every valid split's
    log carries best_epoch; the test splits run once, on the best weights
    (runner_base.py:378-417)."""
    model = _llama()
    ids = _ids(4, 8)
    val_aggs = {0: 1.0, 1: 5.0, 2: 2.0}
    seen_aggs = {0: 1.0, 1: 2.0, 2: 9.0}
    state = {"epoch": -1, "test_weights": []}

    class FakeTask:
        def evaluation(self, data):
            if data["split"] == "test":
                state["test_weights"].append(model.lm_head.weight.detach().clone())
                return {"agg_metrics": 0.0}
            aggs = val_aggs if data["split"] == "val" else seen_aggs
            return {"agg_metrics": aggs[state["epoch"]]}

    def epoch_batches(e):
        state["epoch"] = e
        return [{"input_ids": ids}]

    r = TrainRunner(str(tmp_path), "split", max_epoch=3)
    best = r.train(_loss, model, epoch_batches, task=FakeTask(),
                   optimizer=torch.optim.Adam(model.parameters(), lr=1e-2),
                   valid_splits_fn=lambda: {"val": {"split": "val"},
                                            "val_seen": {"split": "val_seen"}},
                   test_splits_fn=lambda: {"test": {"split": "test"}})
    assert r.best_epoch == 1
    assert len(state["test_weights"]) == 1
    assert torch.equal(state["test_weights"][0], best["lm_head.weight"])
    logs = [json.loads(x) for x in (tmp_path / "evaluate.txt").read_text().splitlines()]
    assert [v["best_epoch"] for x in logs for k, v in x.items() if k == "val"] == [0, 1, 1]
    test_logs = [v for x in logs for k, v in x.items() if k == "test"]
    assert len(test_logs) == 1 and test_logs[0]["epoch"] == 1


# -- processors and RandAugment ------------------------------------------------------

def _image(seed=0, shape=(40, 52, 3)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cls", ["ImageTrainProcessor", "BlipImageTrainProcessor"])
def test_train_processors_are_the_jax_ones_bit_for_bit(cls, seed):
    j = getattr(jproc, cls)(image_size=24, seed=seed)
    t = getattr(tproc, cls)(image_size=24, seed=seed)
    for i in range(4):  # the generator advances alike
        img = _image(seed * 10 + i)
        np.testing.assert_array_equal(t(img), j(img))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randaugment_is_the_jax_one_bit_for_bit(seed):
    """Every op of the full list at magnitude 9, three ops a call."""
    j = jra.RandomAugment(3, 9, rng=np.random.default_rng(seed))
    t = tra.RandomAugment(3, 9, rng=np.random.default_rng(seed))
    for i in range(6):
        img = _image(seed + 100 * i, (32, 32, 3))
        np.testing.assert_array_equal(t(img), j(img))
    np.testing.assert_array_equal(tra.posterize(_image(), 0), jra.posterize(_image(), 0))
    np.testing.assert_array_equal(tra.solarize(_image(), 77), jra.solarize(_image(), 77))
    with pytest.raises(ValueError, match="unknown augment"):
        tra.RandomAugment(augs=["Nope"])


@pytest.mark.parametrize("text", ["A Dog.  Runs!", "Is it: a (red) dog?", "x " * 60])
def test_text_processors_are_the_jax_ones(text):
    assert tproc.CaptionProcessor(prompt="a photo of ")(text) == \
        jproc.CaptionProcessor(prompt="a photo of ")(text)
    assert tproc.QuestionProcessor()(text) == jproc.QuestionProcessor()(text)


def test_processors_are_registered_under_the_reference_names():
    from ecoflap_tpu_torch.core.registry import registry

    assert registry.get_processor_class("blip_image_train") is tproc.BlipImageTrainProcessor
    assert registry.get_processor_class("blip2_image_train") is tproc.ImageTrainProcessor
    assert registry.get_processor_class("blip_question") is tproc.QuestionProcessor


# -- the prune CLI's --stacks ---------------------------------------------------------

def test_stacks_prunes_as_the_jax_cli(tmp_path, monkeypatch):
    """``--stacks visual_encoder.blocks``: the coarse stage scores every
    target, the fine stage prunes the ViT alone (cli/prune.py:638-645); the
    same dict and the same masks as the JAX CLI, the MeZO z injected as the
    JAX CLI's draws (its key is PRNGKey(--seed))."""
    from ecoflap_tpu.cli.prune import main as jmain
    from ecoflap_tpu.utils import checkpoint as jck
    from ecoflap_tpu_torch.cli.prune import main as tmain
    from ecoflap_tpu_torch.pruning import loader
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml

    cfg, params, _ = tiny_pair(seed=0)
    ckpt = str(tmp_path / "tiny.pth")
    jck.save_torch_checkpoint(jck.export_blip2(params, cfg), ckpt)
    real = loader.load_pruner
    monkeypatch.setattr(loader, "load_pruner", lambda name, ad, data, n, pcfg: real(
        name, ad, data, n, {**pcfg, "noise": jax_noise(jax.random.PRNGKey(42))}))
    argv = ["--model", "blip2_t5", "--model_scale", "tiny", "--ckpt", ckpt,
            "--vit_prune_spec", "3-0.5-1.0-1.0", "--t5_prune_spec", "2-0.5-1.0-1.0",
            "--stacks", "visual_encoder.blocks", "--sparsity_ratio_granularity", "block",
            "--max_sparsity_per_layer", "0.6", "--num_data_first_stage", "8",
            "--noise_eps", "0.2", "--num_samples", "8", "--batch_size", "4",
            "--save_pruned_model"]
    want = jmain(argv + ["--platform", "cpu", "--output_dir", str(tmp_path / "j")])
    got = tmain(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "t")])
    jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
    assert set(jd) == set(td) and len(td) == 48
    for k in jd:
        assert abs(jd[k] - td[k]) < 1e-9, k
    a = torch.load(want["pth"], weights_only=True)
    b = torch.load(got["pth"], weights_only=True)
    for k in a:
        assert torch.equal(a[k] == 0, b[k] == 0), k
    vit = [k for k in b if k.startswith("visual_encoder.blocks.") and k.endswith(
        ("qkv.weight", "proj.weight", "fc1.weight", "fc2.weight"))]
    t5 = [k for k in b if ".SelfAttention.q.weight" in k]
    assert vit and all(float((b[k] == 0).float().mean()) > 0.2 for k in vit)
    assert t5 and all(int((b[k] == 0).sum()) == 0 for k in t5)  # not pruned
