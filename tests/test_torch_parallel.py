"""The port's parallel layer on the CPU: the ``--mesh`` grammar and
``make_mesh``'s errors against the JAX package, the start-up matrix of
``init_distributed_mode``, every parameter's tensor-parallel placement
against the JAX rules, ``linear()`` outside a mesh, the dp slice of a batch,
and a sharded tiny-LLaMA forward and backward on 4 gloo ranks
(tests/torch_dist.py)."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.parallel import mesh as jmesh
from ecoflap_tpu.parallel.sharding import _fit_spec, spec_for_path
from ecoflap_tpu_torch.models.convert import jax_to_state_dict
from ecoflap_tpu_torch.parallel import mesh as tmesh
from ecoflap_tpu_torch.parallel.dist import init_distributed_mode
from ecoflap_tpu_torch.parallel.sharding import placement, shard_batch
from tests.torch_dist import Ranks
from tests.torch_parity import llama_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the JAX grammar test's cases (test_cli.py:284-296) and a few more
GOOD = ["dp", "dp=4,tp=2", "tp=2", "dp=8", "dp=1,tp=1", "tp=4,dp=2"]
BAD = ["dp4", "dp=4;tp=2", "pp=2", "dp=x", "", "dp=2,tp=y"]


@pytest.mark.parametrize("spec", GOOD)
def test_mesh_spec_parses_as_the_jax_grammar(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", BAD)
def test_bad_mesh_spec_raises_the_jax_error(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError, match="--mesh") as got:
        tmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


def test_make_mesh_on_one_process():
    """Without a process group the world is one rank."""
    m = tmesh.make_mesh()
    assert m.shape == {"dp": 1, "tp": 1} and (m.dp_rank, m.tp_rank) == (0, 0)
    assert m.dp_group is None and m.tp_group is None


@pytest.mark.parametrize("kw,match", [
    ({"tp": 2}, "tp=2 does not divide"),
    ({"dp": 2}, r"dp\*tp = 2 != 1 ranks.*torchrun --nproc-per-node 2"),
    ({"dp": 4, "tp": 2}, r"torchrun --nproc-per-node 8"),
])
def test_make_mesh_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(**kw)


def test_jax_make_mesh_raises_alike(devices):
    with pytest.raises(ValueError, match="does not divide"):
        jmesh.make_mesh(tp=3)
    with pytest.raises(ValueError, match=r"dp\*tp = 4 != 8"):
        jmesh.make_mesh(dp=2, tp=2)


ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
FULL = {"RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2",
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}


@pytest.mark.parametrize("env,want", [
    ({}, None),
    (FULL, dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=4,
                rank=2)),
    ({**FULL, "WORLD_SIZE": "1", "RANK": "0"},
     dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=1, rank=0)),
    ({"WORLD_SIZE": "2"}, RuntimeError),
    ({"WORLD_SIZE": "2", "RANK": "1"}, RuntimeError),
    ({**FULL, "MASTER_ADDR": ""}, RuntimeError),
    ({"RANK": "0"}, None),
], ids=["nothing", "torchrun", "one_rank", "world_only", "no_address",
        "empty_address", "rank_only"])
def test_init_distributed_env_matrix(monkeypatch, env, want):
    """init_distributed_mode's branches with an injected init (the JAX
    test_infra.py:90-139 matrix over torchrun's variables): a complete set
    starts a group, a half-configured multi-rank run fails loudly, nothing
    set is a no-op."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="torchrun"):
            init_distributed_mode("cpu", init_fn=lambda **kw: calls.append(kw))
        assert calls == []
        return
    started = init_distributed_mode("cpu", init_fn=lambda **kw: calls.append(kw))
    assert started is (want is not None)
    assert calls == ([] if want is None else [want])


def test_nccl_follows_the_card(monkeypatch):
    """The backend follows the device: a cuda run asks for NCCL (and sets
    the rank's card first), never gloo."""
    for k, v in FULL.items():
        monkeypatch.setenv(k, v)
    calls, devices = [], []
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    init_distributed_mode("cuda", init_fn=lambda **kw: calls.append(kw))
    assert calls[0]["backend"] == "nccl" and devices == [2]


# -- placement against the JAX rules ---------------------------------------------

class _TP2:
    shape = {"dp": 4, "tp": 2}


def _families():
    from ecoflap_tpu.models import bert as jbert
    from ecoflap_tpu.models import blip1 as jblip1
    from ecoflap_tpu.models import blip2 as jblip2
    from ecoflap_tpu.models import blip2_opt as jbo
    from ecoflap_tpu.models import blip2_qformer as jq
    from ecoflap_tpu.models import classifiers as jcls
    from ecoflap_tpu.models import clip as jclip
    from ecoflap_tpu.models import llama as jllama
    from ecoflap_tpu.models import opt as jopt
    from ecoflap_tpu.models import t5 as jt5
    from ecoflap_tpu_torch.models import bert as tbert
    from ecoflap_tpu_torch.models import blip1 as tblip1
    from ecoflap_tpu_torch.models import blip2 as tblip2
    from ecoflap_tpu_torch.models import blip2_opt as tbo
    from ecoflap_tpu_torch.models import blip2_qformer as tq
    from ecoflap_tpu_torch.models import classifiers as tcls
    from ecoflap_tpu_torch.models import clip as tclip
    from ecoflap_tpu_torch.models import llama as tllama
    from ecoflap_tpu_torch.models import opt as topt
    from ecoflap_tpu_torch.models import t5 as tt5

    cpu = dict(device="cpu", seed=None)
    blip1_init = {"caption": "init_params", "vqa": "init_vqa_params",
                  "nlvr": "init_nlvr_params", "retrieval": "init_retrieval_params"}
    fams = {
        "blip2": lambda: (jblip2.init_params, jblip2.tiny_config(),
                          tblip2.build_model(tblip2.tiny_config(), **cpu)),
        "llama": lambda: (jllama.init_params, jllama.tiny_config(),
                          tllama.build_model(tllama.tiny_config(), **cpu)),
        "t5": lambda: (jt5.init_params, jt5.tiny_config(),
                       tt5.build_model(tt5.tiny_config(), **cpu)),
        "clip": lambda: (jclip.init_params, jclip.tiny_config(),
                         tclip.build_model(tclip.tiny_config(), **cpu)),
        "eva_clip": lambda: (jclip.init_params, jclip.tiny_config(eva=True),
                             tclip.build_model(tclip.tiny_config(eva=True), **cpu)),
        "deit": lambda: (jcls.build("deit", "tiny")[1], jcls.build("deit", "tiny")[0],
                         tcls.build_model(tcls.build("deit", "tiny"), **cpu)),
        "convnext": lambda: (jcls.init_params, jcls.tiny_config(),
                             tcls.build_model(tcls.tiny_config(), **cpu)),
        "opt": lambda: (jopt.init_params, jopt.tiny_config(),
                        topt.build_model(topt.tiny_config(), **cpu)),
        "blip2_opt": lambda: (jbo.init_params, jbo.tiny_config(),
                              tbo.build_model(tbo.tiny_config(), **cpu)),
        "blip2_qformer": lambda: (jq.init_params, jq.tiny_config(),
                                  tq.build_model(tq.tiny_config(), **cpu)),
        "bert": lambda: (jbert.init_params, jbert.tiny_config(),
                         tbert.BertLMHeadModel(tbert.tiny_config()).eval()),
    }
    for head, init in blip1_init.items():
        fams[f"blip1_{head}"] = (lambda h=head, i=init: (
            getattr(jblip1, i), jblip1.tiny_config(),
            tblip1.build_model(tblip1.tiny_config(), f"blip_{h}", **cpu)))
    return fams


FAMILIES = sorted(_families())


def _encoded(flat):
    """Each JAX leaf as float32 values that spell its id and, along the axis
    the JAX rules shard at tp=2 (after ``_fit_spec``), its index there."""
    out, sharded = {}, {}
    for i, (path, a) in enumerate(sorted(flat.items())):
        a = np.asarray(a)
        spec = _fit_spec(spec_for_path(path), a.ndim, a.shape, _TP2)
        axes = [d for d, p in enumerate(spec) if p == "tp"]
        v = np.full(a.shape, i * 4096.0, np.float32)
        if axes:
            shape = [1] * a.ndim
            shape[axes[0]] = a.shape[axes[0]]
            v = v + np.arange(a.shape[axes[0]], dtype=np.float32).reshape(shape)
            sharded[path] = axes[0]
        out[path] = v
    return out, sharded


@pytest.mark.parametrize("family", FAMILIES)
def test_placement_matches_the_jax_rules(family):
    """Every port parameter, loaded from its JAX leaf through
    ``models/convert.py:jax_to_state_dict`` and the module's own load hooks
    (CLIP's ``in_proj_weight`` lands in ``attn.in_proj.weight``), is split
    over tp on the dim that carries the JAX leaf's tp axis, and only then
    (both directions: a JAX-sharded leaf shows as varying along one port
    dim, a replicated one as constant, and ``placement`` must name that dim
    or None). A key that loads into no parameter must not be one the JAX
    rules shard."""
    init, jcfg, model = _families()[family]()
    params = jax.eval_shape(lambda k: init(jcfg, k), jax.random.PRNGKey(0))
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_named(params).items()}
    enc, jax_sharded = _encoded(flat)
    sd = jax_to_state_dict(enc, model.cfg, model)
    model.to(torch.float32)
    res = model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                                strict=False)
    for k in res.unexpected_keys:
        assert np.ptp(np.asarray(sd[k])) == 0, ("a JAX-sharded leaf loads nowhere", k)
    port_sharded = 0
    for name, p in model.named_parameters(remove_duplicate=False):
        if name in res.missing_keys:
            continue
        arr = p.detach().numpy()
        varying = [d for d in range(arr.ndim)
                   if arr.shape[d] > 1 and np.ptp(arr, axis=d).max() > 0]
        assert len(varying) <= 1, (name, varying)
        want = varying[0] if varying else None
        got = placement(name, tuple(arr.shape), 2)
        assert got == want, (name, got, want)
        port_sharded += got is not None
    # the families the JAX rules shard, the port shards too, and as often
    assert (port_sharded > 0) == bool(jax_sharded), (port_sharded, jax_sharded)


# -- seams outside a mesh ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_is_f_linear_outside_a_mesh(dtype):
    from ecoflap_tpu_torch.models.layers import embedding, linear, linear_f32, logits_f32

    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(48, 40).to(dtype)
    x = torch.randn(3, 5, 48, generator=g).to(dtype)
    assert torch.equal(linear(x, lin), F.linear(x, lin.weight, lin.bias))
    assert torch.equal(linear_f32(x, lin), logits_f32(x, lin.weight))
    assert torch.equal(linear_f32(x, lin, widen=True),
                       F.linear(x.float(), lin.weight.float()))
    emb = torch.nn.Embedding(30, 16).to(dtype)
    ids = torch.randint(0, 30, (2, 7), generator=g)
    assert torch.equal(embedding(ids, emb), emb(ids))


def test_shard_batch_slices_and_leaves_indivisible_leaves_whole():
    """This rank's contiguous slice of every leaf that leads with the batch;
    a shared table (leading 1) rides whole; a batch that dp does not divide
    rides whole on every rank (sharding.py:123-130)."""
    m = tmesh.Mesh(dp=2, tp=1, dp_rank=1, tp_rank=0)
    batch = {"ids": torch.arange(12).reshape(6, 2), "table": torch.ones(1, 4),
             "names": ["a", "b", "c", "d", "e", "f"]}
    out = shard_batch(batch, m)
    assert torch.equal(out["ids"], batch["ids"][3:])
    assert out["table"] is batch["table"]
    odd = {"ids": torch.arange(10).reshape(5, 2)}
    assert shard_batch(odd, m)["ids"] is odd["ids"]
    with tmesh.use_mesh(m):
        assert tmesh.dp_split(6) and not tmesh.dp_split(5)
        x = torch.arange(5.0)
        assert tmesh.dp_gather(x, 5) is x  # not cut: not gathered
    assert tmesh.current() is None and not tmesh.dp_split(6)


# -- the sharded forward on 4 ranks ------------------------------------------------

LLAMA_CFG = dict(d_model=64, d_ff=128, num_heads=8, num_kv_heads=8)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The two 4-rank runs (dp=2,tp=2), started with the module: the tests
    above run while they do. Weights converted from the JAX init (the JAX
    test_parallel.py:32-47 configuration)."""
    out = {}
    for name, seed in (("llama_forward", 0), ("llama_grads", 1)):
        cfg, params, model = llama_pair(seed=seed, **LLAMA_CFG)
        ids = np.random.default_rng(seed).integers(2, cfg.vocab_size, size=(8, 12))
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        ranks = Ranks(name, 4, {"cfg": LLAMA_CFG, "sd": sd, "ids": ids, "dp": 2, "tp": 2},
                      tmp_path_factory.mktemp(name))
        out[name] = (ranks, cfg, params, model, ids)
    return out


@pytest.fixture(scope="module")
def sharded_forward(started):
    from ecoflap_tpu.models import llama as jllama

    ranks, cfg, params, model, ids = started["llama_forward"]
    with torch.no_grad():
        f32 = model(torch.from_numpy(ids)).numpy()
        bf16 = model.to(torch.bfloat16)(torch.from_numpy(ids)).float().numpy()
    jax_ref = np.asarray(jllama.forward(cfg, params, jax.numpy.asarray(ids, "int32")))
    return ranks.wait(), f32, bf16, jax_ref


def test_sharded_forward_matches_one_process_f32(sharded_forward):
    res, f32, _, jax_ref = sharded_forward
    assert sorted(r["coords"] for r in res) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        np.testing.assert_allclose(r["f32"], f32, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["f32"], jax_ref, rtol=2e-4, atol=2e-4)


def test_sharded_forward_matches_one_process_bf16(sharded_forward):
    """bf16 weights: column products joined exactly, row products summed in
    float32 and rounded once, so the logits hold to the unsharded ones."""
    res, _, bf16, _ = sharded_forward
    for r in res:
        np.testing.assert_allclose(r["bf16"], bf16, rtol=2e-4, atol=2e-4)


def test_sharded_weights_are_local_slices(sharded_forward):
    res, _, _, _ = sharded_forward
    r = res[0]
    assert r["sharded"]["model.layers.0.self_attn.q_proj.weight"] == 0
    assert r["sharded"]["model.layers.0.mlp.down_proj.weight"] == 1
    assert r["sharded"]["model.embed_tokens.weight"] == 1
    assert r["sharded"]["lm_head.weight"] == 0
    assert r["local_shapes"]["model.layers.0.self_attn.q_proj.weight"] == (32, 64)
    assert r["local_shapes"]["model.layers.0.mlp.down_proj.weight"] == (64, 64)
    assert r["local_shapes"]["model.norm.weight"] == (64,)


@pytest.fixture(scope="module")
def sharded_grads(started):
    ranks, _, _, model, ids = started["llama_grads"]
    model.requires_grad_(True)
    loss = model.per_sample_loss(torch.from_numpy(ids)).mean()
    loss.backward()
    want = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return ranks.wait(), float(loss.detach()), want


def test_sharded_backward_matches_one_process(sharded_grads):
    """Megatron's conjugate backwards: every weight's whole gradient (dp
    sums, tp slices gathered) equals the unsharded one, replicated and
    sharded parameters alike."""
    res, loss, want = sharded_grads
    for r in res:
        assert abs(r["loss"] - loss) < 1e-5
        assert set(r["grads"]) == set(want)
        for n, g in want.items():
            np.testing.assert_allclose(r["grads"][n], g, rtol=1e-4, atol=1e-6,
                                       err_msg=n)


def test_dist_single_process():
    """Without a group: rank 0 of 1, the main process, and ``main_process``
    runs what it wraps (dist_utils.py:107-114)."""
    from ecoflap_tpu_torch.parallel import dist as tdist

    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    assert tdist.is_main_process() and not tdist.is_dist_avail_and_initialized()
    assert tdist.main_process(lambda x: x + 1)(2) == 3
    assert tdist.same_on_every_rank({"a": 1}) == {"a": 1}
