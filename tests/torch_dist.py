"""Multi-rank harness for the port's parallel tests: ``run_ranks`` starts N
gloo ranks on the CPU, each a fresh Python process with one torch thread,
on a free local port, and returns each rank's result.

The parent (a pytest test, which may use JAX) prepares numpy inputs, the
JAX-converted weights and any injected noise, and hands them to the children
in a file. The children import torch and ``ecoflap_tpu_torch`` only, never
JAX: the work they run lives in this module, which imports neither JAX nor
the JAX package. ``torchrun`` is not needed here; each child gets the
environment that ``torchrun`` would set and starts its group through
``ecoflap_tpu_torch.parallel.dist.init_distributed_mode``.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """What torchrun sets for one rank, plus one thread per rank."""
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    return env


class Ranks:
    """``world`` started ranks; ``wait`` returns their results, rank 0
    first. A rank that fails fails the wait with its stderr. ``nice`` lowers
    the ranks' priority: a parent that computes while they run, and the
    test workers beside them, keep theirs."""

    def __init__(self, fn: str, world: int, payload: Any, tmp_path: Path,
                 timeout: float = 120.0, nice: int = 10):
        tmp_path = Path(tmp_path)
        tmp_path.mkdir(parents=True, exist_ok=True)
        src = tmp_path / f"{fn}_payload.pkl"
        with open(src, "wb") as f:
            pickle.dump(payload, f)
        port = free_port()
        self.timeout = timeout
        self.procs = []
        for r in range(world):
            out = tmp_path / f"{fn}_rank{r}.pkl"
            code = (f"import os, torch_dist; os.nice({nice}); "
                    f"torch_dist._child({fn!r}, {str(src)!r}, {str(out)!r})")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", code], env=rank_env(r, world, port),
                cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), out))

    def wait(self) -> List[Any]:
        results, errors = [], []
        for r, (p, out) in enumerate(self.procs):
            try:
                _, se = p.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                for q, _ in self.procs:
                    q.kill()
                raise
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{se[-4000:]}")
                continue
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        if errors:
            raise AssertionError("\n".join(errors))
        return results


def run_ranks(fn: str, world: int, payload: Any, tmp_path: Path,
              timeout: float = 120.0) -> List[Any]:
    """Run ``torch_dist.<fn>(payload)`` on ``world`` gloo ranks; returns the
    ranks' return values, rank 0 first."""
    return Ranks(fn, world, payload, tmp_path, timeout).wait()


def _child(fn: str, src: str, out: str) -> None:
    import torch

    torch.set_num_threads(1)
    from ecoflap_tpu_torch.parallel.dist import destroy, init_distributed_mode

    assert init_distributed_mode("cpu")
    with open(src, "rb") as f:
        payload = pickle.load(f)
    try:
        result = globals()[fn](payload)
    finally:
        destroy()
    with open(out, "wb") as f:
        pickle.dump(result, f)


# -- helpers the children use ----------------------------------------------------

def _np(t):
    import torch

    return t.detach().to(torch.float32).cpu().numpy() if isinstance(t, torch.Tensor) else t


def _torch_batch(batch):
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


def _llama(payload, dtype=None):
    import torch

    from ecoflap_tpu_torch.models import llama

    model = llama.build_model(llama.tiny_config(**payload.get("cfg", {})), device="cpu",
                              dtype=torch.float32, seed=None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in payload["sd"].items()})
    if dtype is not None:
        model.to(dtype)
    return model


def _mesh(payload):
    from ecoflap_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=payload.get("dp"), tp=payload.get("tp", 1), device="cpu")


def _gathered_state(model) -> Dict[str, Any]:
    """Every parameter whole (tp slices gathered), the model left as it is."""
    from ecoflap_tpu_torch.parallel.sharding import full_weight

    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = _np(full_weight(mod, pname))
    return out


def _noise(draws: Optional[Dict]) -> Optional[Callable]:
    """A MeZO noise hook replaying the parent's draws, keyed (target,
    microbatch, draw)."""
    if draws is None:
        return None
    import torch

    def noise(ti, b, n, shape):
        z = draws[(ti, b, n)]
        assert tuple(z.shape) == tuple(shape), (z.shape, shape)
        return torch.from_numpy(z)

    return noise


# -- work ------------------------------------------------------------------------

def llama_forward(payload):
    """The tiny LLaMA's logits under the mesh, float32 and bf16, plus what
    each rank holds of every weight."""
    import torch

    from ecoflap_tpu_torch.parallel.mesh import use_mesh
    from ecoflap_tpu_torch.parallel.sharding import shard_of, shard_params

    mesh = _mesh(payload)
    out = {"coords": (mesh.dp_rank, mesh.tp_rank)}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = _llama(payload, dtype)
        shard_params(model, mesh)
        ids = torch.from_numpy(payload["ids"])
        with torch.no_grad(), use_mesh(mesh):
            out[name] = _np(model(ids))
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["sharded"] = {f"{m}.{p}": shard_of(mod, p).dim for m, mod in model.named_modules()
                      for p in getattr(mod, "_tp_shards", {})}
    return out


def llama_grads(payload):
    """The tiny LLaMA's mean loss and every parameter's whole gradient under
    the mesh: this rank's share summed over dp, a sharded slice gathered
    over tp."""
    import torch

    from ecoflap_tpu_torch.parallel.mesh import (all_gather_cat, dp_gather, dp_slice,
                                                 dp_sum_, use_mesh)
    from ecoflap_tpu_torch.parallel.sharding import shard_of, shard_params

    mesh = _mesh(payload)
    model = _llama(payload)
    shard_params(model, mesh)
    model.requires_grad_(True)
    ids = torch.from_numpy(payload["ids"])
    n = ids.shape[0]
    with use_mesh(mesh):
        loss = dp_gather(model.per_sample_loss(dp_slice(ids, n)), n).mean()
        loss.backward()
        grads = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                g = dp_sum_(p.grad.clone())
                sh = shard_of(mod, pname)
                if sh is not None:
                    g = all_gather_cat(g, sh.dim, sh.group, sh.size)
                grads[f"{mname}.{pname}" if mname else pname] = _np(g)
    return {"loss": float(loss.detach()), "grads": grads}


def llama_suite(payload):
    """On one mesh, from the same dense tiny LLaMA each time: the two-stage
    prune (MeZO coarse stage + Wanda), SparseGPT from that dict, a
    first-order coarse stage + Wanda, then masked AdamW steps of the first
    pruned model. Returns each run's dict and whole weights, as gathered on
    this rank."""
    import torch

    from ecoflap_tpu_torch.models import llama
    from ecoflap_tpu_torch.parallel.mesh import use_mesh
    from ecoflap_tpu_torch.parallel.sharding import shard_params
    from ecoflap_tpu_torch.pruning.pruners import SparseGPTPruner, TwoStagePruner
    from ecoflap_tpu_torch.runners.finetune import adamw, finetune

    mesh = _mesh(payload)
    batch = _torch_batch(payload["batch"])
    out = {"coords": (mesh.dp_rank, mesh.tp_rank)}

    def prune(cls, cfg, noise=None):
        model = _llama(payload)
        shard_params(model, mesh)
        pruner = cls(llama.make_adapter(model), batch, payload["num_mb"], noise=noise,
                     verbose=False, **cfg)
        with torch.no_grad(), use_mesh(mesh):
            _, sdict = pruner.prune()
            sparsity = pruner.check_sparsity()
        return model, {"dict": dict(sdict), "sparsity": sparsity,
                       "scores": dict(pruner.leaf_scores)}

    model, out["mezo"] = prune(TwoStagePruner, payload["mezo"], _noise(payload["draws"]))
    out["mezo"]["state"] = _gathered_state(model)
    sgpt, out["sparsegpt"] = prune(SparseGPTPruner,
                                   {**payload["sparsegpt"],
                                    "sparsity_dict": out["mezo"]["dict"]})
    out["sparsegpt"]["state"] = _gathered_state(sgpt)
    fo, out["first_order"] = prune(TwoStagePruner, payload["first_order"])
    out["first_order"]["state"] = _gathered_state(fo)
    with use_mesh(mesh):
        _, losses = finetune(lambda m, b: m.per_sample_loss(b["input_ids"]), model,
                             [batch] * payload["steps"],
                             optimizer=adamw(model, payload["lr"], payload["wd"]))
    out["finetune"] = {"losses": losses, "state": _gathered_state(model)}
    return out


def _blip2(payload):
    import torch

    from ecoflap_tpu_torch.models import blip2, eva_vit, qformer
    from ecoflap_tpu_torch.models import t5 as t5_mod

    c = payload["cfg"]
    cfg = blip2.Blip2Config(vit=eva_vit.EvaViTConfig(**c["vit"]), t5=t5_mod.T5Config(**c["t5"]),
                            qformer=qformer.QFormerConfig(**c["qformer"]))
    model = blip2.build_model(cfg, device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in payload["sd"].items()})
    return model


def blip2_dryrun(payload):
    """The multi-device dry run of the JAX package, in the port on one mesh:
    MeZO coarse stage + Wanda on every stack, SparseGPT from that dict on the
    dense weights, then one masked AdamW step of the Wanda-pruned model."""
    import torch

    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.parallel.mesh import use_mesh
    from ecoflap_tpu_torch.parallel.sharding import shard_params
    from ecoflap_tpu_torch.pruning.pruners import SparseGPTPruner, TwoStagePruner
    from ecoflap_tpu_torch.runners.finetune import adamw, finetune

    mesh = _mesh(payload)
    batch = _torch_batch(payload["batch"])
    out = {}
    model = _blip2(payload)
    shard_params(model, mesh)
    p = TwoStagePruner(blip2.make_adapter(model), batch, 2, noise=_noise(payload["draws"]),
                       verbose=False, **payload["mezo"])
    with torch.no_grad(), use_mesh(mesh):
        _, sdict = p.prune()
        out["sparsity"] = p.check_sparsity()
    out["dict"] = dict(sdict)
    dense = _blip2(payload)
    shard_params(dense, mesh)
    s = SparseGPTPruner(blip2.make_adapter(dense), batch, 2, sparsity_dict=sdict,
                        verbose=False, stack_specs=payload["mezo"]["stack_specs"])
    with torch.no_grad(), use_mesh(mesh):
        _, sgpt_dict = s.prune()
        out["sgpt_sparsity"] = s.check_sparsity()
    out["sgpt_dict_verbatim"] = dict(sgpt_dict) == dict(sdict)
    with use_mesh(mesh):
        _, losses = finetune(lambda m, b: m.per_sample_loss(b), model, [batch],
                             optimizer=adamw(model, 1e-5, 0.05))
    out["loss"] = losses[0]
    return out


def blip2_dp_generate(payload):
    """Tiny BLIP-2's generated ids over a batch through ``dp_map``: each dp
    rank generates for its slice, the ranks' outputs gathered."""
    import torch

    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig
    from ecoflap_tpu_torch.parallel.mesh import use_mesh
    from ecoflap_tpu_torch.parallel.sharding import dp_map

    mesh = _mesh(payload)
    model = blip2.build_model(blip2.tiny_config(), device="cpu", seed=payload["seed"])
    gen = GenerateConfig(max_new_tokens=4, num_beams=2)

    def predict(b):
        return model.generate(torch.from_numpy(b["image"]), torch.from_numpy(b["ids"]),
                              torch.from_numpy(b["mask"]), gen).tolist()

    with torch.no_grad(), use_mesh(mesh):
        return dp_map(predict)(payload["batch"])


def smoothed_value_sync(payload):
    """Each rank's SmoothedValue and MetricLogger after
    ``synchronize_between_processes``."""
    from ecoflap_tpu_torch.parallel.dist import get_rank
    from ecoflap_tpu_torch.utils.logger import MetricLogger, SmoothedValue

    r = get_rank()
    sv = SmoothedValue(window_size=4)
    for v in payload["values"][r]:
        sv.update(v)
    sv.synchronize_between_processes()
    ml = MetricLogger()
    ml.update(loss=payload["values"][r][0])
    ml.synchronize_between_processes()
    return {"count": sv.count, "total": sv.total, "global_avg": sv.global_avg,
            "avg": sv.avg, "logger_global": ml.meters["loss"].global_avg}
