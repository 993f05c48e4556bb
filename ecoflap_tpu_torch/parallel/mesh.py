"""The (dp, tp) mesh over the ranks of a ``torch.distributed`` run (port of
``ecoflap_tpu/parallel/mesh.py``).

On a TPU one process drives eight devices and a mesh is declarative. Here
a mesh is ``dp x tp`` processes, one rank each, laid out row-major as the
JAX mesh lays out its devices: rank ``r`` sits at ``(r // tp, r % tp)``.

Axes:
  ``dp`` -- data parallel: each rank takes its slice of every calibration
  microbatch; sums of statistics and gradients are all-reduced over it.
  ``tp`` -- tensor parallel: the weights the rules of ``sharding.py`` match
  are split over it; activations stay whole on every rank.

The active mesh (``use_mesh``) is read by the pruning code for its dp
reductions; the tp groups travel with the sharded modules themselves.
Every collective below is a no-op on an axis of extent 1.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from ecoflap_tpu_torch.parallel.dist import get_rank, get_world_size, is_dist_avail_and_initialized


@dataclass
class Mesh:
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Any = None  # ProcessGroup over this rank's dp axis (None: extent 1)
    tp_group: Any = None
    device_mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def parse_mesh_spec(spec: str) -> dict:
    """CLI mesh grammar shared by prune/evaluate: ``'dp'`` (every rank on
    the batch axis) or ``'dp=N[,tp=M]'`` -> make_mesh kwargs, with parser
    -grade errors instead of raw unpacking tracebacks (mesh.py:49-71)."""
    if spec == "dp":
        return {"dp": None, "tp": 1}
    kv = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad --mesh spec {spec!r}: expected 'dp' or 'dp=N[,tp=M]'")
        k, v = part.split("=", 1)
        if k not in ("dp", "tp"):
            raise ValueError(
                f"bad --mesh axis {k!r} in {spec!r} (axes: dp, tp)")
        try:
            kv[k] = int(v)
        except ValueError:
            raise ValueError(
                f"bad --mesh extent {v!r} for axis {k!r} in {spec!r}")
    if not kv:
        raise ValueError(f"empty --mesh spec {spec!r}")
    return {"dp": kv.get("dp"), "tp": kv.get("tp", 1)}


def make_mesh(dp: Optional[int] = None, tp: int = 1, device="cpu") -> Mesh:
    """A (dp, tp) mesh over every rank of the default group (one process
    without a group is a world of 1). ``dp`` defaults to world // tp. A
    mesh whose ``dp * tp`` is not the world size raises and names the
    ``torchrun`` that it needs."""
    n = get_world_size()
    if dp is not None and dp * tp != n:
        raise ValueError(
            f"dp*tp = {dp * tp} != {n} ranks: a --mesh of dp={dp},tp={tp} runs "
            f"under torchrun --nproc-per-node {dp * tp}")
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide the world size {n} (run under "
                         f"torchrun --nproc-per-node a multiple of {tp})")
    if dp is None:
        dp = n // tp
    rank = get_rank()
    mesh = Mesh(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp)
    if is_dist_avail_and_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        mesh.device_mesh = init_device_mesh(torch.device(device).type, (dp, tp),
                                            mesh_dim_names=("dp", "tp"))
        mesh.dp_group = mesh.device_mesh.get_group("dp") if dp > 1 else None
        mesh.tp_group = mesh.device_mesh.get_group("tp") if tp > 1 else None
    return mesh


def mesh_from_flag(spec: Optional[str], device="cpu") -> Optional[Mesh]:
    """The CLIs' ``--mesh``: None for no flag or ``none``, else the mesh of
    its spec over the started process group."""
    if not spec or spec == "none":
        return None
    return make_mesh(**parse_mesh_spec(spec), device=device)


_ACTIVE: List[Mesh] = []


def current() -> Optional[Mesh]:
    """The mesh of the innermost ``use_mesh``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the active one for the block (None: no mesh)."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


# -- collectives ---------------------------------------------------------------

def all_gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def rank_slice(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


class _GatherSlice(torch.autograd.Function):
    """All-gather along ``dim``; backward: this rank's slice of the
    gradient. For a result that every rank then uses whole (a replicated
    activation), whose gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, rank, size)
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, rank, size = ctx.args
        return rank_slice(g, dim, rank, size).contiguous(), None, None, None, None


class _SliceGather(torch.autograd.Function):
    """This rank's slice along ``dim``; backward: the all-gather of the
    ranks' gradients (each rank's slice takes its own)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, group, size)
        return rank_slice(x, dim, rank, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        return all_gather_cat(g, dim, group, size), None, None, None, None


class _CopyReduce(torch.autograd.Function):
    """Identity; backward: all-reduce (Megatron's ``f``): a replicated input
    of a column-parallel product takes the sum of the ranks' partial
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceCopy(torch.autograd.Function):
    """All-reduce; backward: identity (Megatron's ``g``): the sum of
    row-parallel partial products, whose gradient every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReduceSlice(torch.autograd.Function):
    """All-gather of a sharded parameter that each rank then uses in part
    (EVA's q/v biases); backward: the sum of the ranks' gradients, sliced."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, group, size, rank)
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, size, rank = ctx.args
        g = all_reduce_(g.contiguous().clone(), group)
        return rank_slice(g, dim, rank, size).contiguous(), None, None, None, None


def gather_slice(x, dim, group, size, rank):
    return _GatherSlice.apply(x, dim, group, size, rank)


def slice_gather(x, dim, group, size, rank):
    return _SliceGather.apply(x, dim, group, size, rank)


def copy_reduce(x, group):
    return _CopyReduce.apply(x, group)


def reduce_copy(x, group):
    return _ReduceCopy.apply(x, group)


def gather_reduce_slice(x, dim, group, size, rank):
    return _GatherReduceSlice.apply(x, dim, group, size, rank)


# -- the dp axis ---------------------------------------------------------------

def dp_size() -> int:
    m = current()
    return m.dp if m is not None else 1


def dp_split(batch_size: int) -> bool:
    """Whether a batch of ``batch_size`` is cut over dp: the active mesh has
    dp > 1 and dp divides it. An indivisible batch rides whole on every rank
    and is not reduced (``shard_batch``, sharding.py:123-130)."""
    d = dp_size()
    return d > 1 and batch_size % d == 0


def dp_slice(tree: Any, batch_size: int, static_keys: Sequence[str] = ()) -> Any:
    """This rank's contiguous dp slice of every tensor of ``tree`` whose
    leading dimension is ``batch_size``; the rest (shared tables, which lead
    with 1, and a dict's ``static_keys``) and every tensor of an indivisible
    batch ride whole."""
    if not dp_split(batch_size):
        return tree
    m = current()

    def sel(x):
        if isinstance(x, torch.Tensor):
            if x.ndim >= 1 and x.shape[0] == batch_size:
                return rank_slice(x, 0, m.dp_rank, m.dp)
            return x
        if isinstance(x, tuple):
            return tuple(sel(v) for v in x)
        if isinstance(x, list):
            return [sel(v) for v in x]
        if isinstance(x, dict):
            return {k: (v if k in static_keys else sel(v)) for k, v in x.items()}
        return x

    return sel(tree)


def dp_gather(x: torch.Tensor, batch_size: int, dim: int = 0) -> torch.Tensor:
    """The whole batch's per-sample values from every rank's slice (the
    ranks' slices concatenated along ``dim`` in rank order); identity when
    the batch of ``batch_size`` was not cut. Differentiable: each rank's
    samples take their slice of the gradient."""
    if not dp_split(batch_size):
        return x
    m = current()
    return gather_slice(x, dim, m.dp_group, m.dp, m.dp_rank)


def dp_sum_(x: torch.Tensor) -> torch.Tensor:
    """In-place all-reduce sum over dp (no-op without one)."""
    m = current()
    if m is not None and m.dp > 1:
        all_reduce_(x, m.dp_group)
    return x
