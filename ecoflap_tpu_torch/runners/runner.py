"""The evaluation loop, the pruning artifacts and the training runners
(port of ``ecoflap_tpu/runners/runner.py``; reference runner_base.py and
evaluate_blip.py:438-472): a task's metrics, logged as one JSON line each to
``evaluate.txt``; ``sparsity_dict/<job>.yaml`` under the reference keys,
``training_statistics/<job>.yaml`` with the wall clock and the card's peak
memory, the pruned model as ``pruned_checkpoint/<job>.pth``; checkpoints
as ``<name>.pth`` (``torch.save``; the port reads and writes no orbax), and
``TrainRunner`` / ``IterTrainRunner``, the masked epoch loop with its best
checkpoint, resume and split-aware evaluation.

The files are flat ``key: value`` YAML written as PyYAML's ``safe_dump``
writes them (sorted keys, floats with a dot), so no YAML package is needed.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from ecoflap_tpu_torch.utils.checkpoint import save_torch_checkpoint


def _yaml_scalar(v: Any) -> str:
    if isinstance(v, float):
        # PyYAML writes 1e-05 as 1.0e-05: YAML 1.1 reads a float only with a dot
        s = repr(v)
        return s.replace("e", ".0e", 1) if "." not in s and "e" in s else s
    return str(v)


def write_flat_yaml(path: str, data: Mapping[str, Any]) -> None:
    with open(path, "w") as f:
        for k in sorted(data):
            f.write(f"{k}: {_yaml_scalar(data[k])}\n")


def read_flat_yaml(path: str) -> Dict[str, float]:
    """Read a flat ``key: number`` YAML such as a saved sparsity dict."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                k, v = line.split(":", 1)
                out[k.strip()] = float(v)
    return out


class Runner:
    """``write=False`` (every rank of a multi-rank run but rank 0) computes
    and returns the artifacts' paths without writing them."""

    def __init__(self, output_dir: str = "output", job_id: str = "job",
                 write: bool = True):
        self.output_dir = output_dir
        self.job_id = job_id
        self.write = write
        if write:
            os.makedirs(output_dir, exist_ok=True)

    # -- evaluation (runner.py:38-66) -------------------------------------------

    def evaluate(self, task, data, split: str = "val", **extra: Any) -> Dict[str, Any]:
        """The task's metrics over ``data``, with the wall and ``extra``,
        logged under ``split``."""
        t0 = time.time()
        metrics = task.evaluation(data)
        metrics["eval_time_s"] = round(time.time() - t0, 2)
        metrics.update(extra)
        self.log_metrics(metrics, split=split)
        return metrics

    def evaluate_splits(self, task, split_data: Mapping[str, Any],
                        cur_epoch: Any = "best") -> Dict[str, Dict[str, Any]]:
        """One evaluation per test split, each logged under its split's
        name (RunnerBase.evaluate, runner_base.py:419-428)."""
        return {name: self.evaluate(task, data, split=name, epoch=cur_epoch)
                for name, data in split_data.items()}

    def log_metrics(self, metrics: Mapping[str, Any], split: str = "val") -> None:
        """Append ``{split: metrics}`` as a JSON line to ``evaluate.txt``
        (the reference's vqa.py:178-181 convention)."""
        if not self.write:
            return
        with open(os.path.join(self.output_dir, "evaluate.txt"), "a") as f:
            f.write(json.dumps({split: dict(metrics)}) + "\n")

    # -- pruning artifacts --------------------------------------------------------

    def _path(self, sub: str) -> str:
        d = os.path.join(self.output_dir, sub)
        if self.write:
            os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{self.job_id}.yaml")

    def save_sparsity_dict(self, sparsity_dict: Optional[Mapping[str, float]]
                           ) -> Optional[str]:
        if sparsity_dict is None:
            return None
        path = self._path("sparsity_dict")
        if self.write:
            write_flat_yaml(path, {k: float(v) for k, v in sparsity_dict.items()})
        return path

    def save_pruned_torch(self, state_dict: Mapping[str, torch.Tensor],
                          name: Optional[str] = None) -> str:
        """The reference-named ``.pth`` under ``pruned_checkpoint/``
        (runner.py:117-126)."""
        d = os.path.join(self.output_dir, "pruned_checkpoint")
        path = os.path.join(d, f"{name or self.job_id}.pth")
        if self.write:
            os.makedirs(d, exist_ok=True)
            save_torch_checkpoint(state_dict, path)
        return path

    def save_training_statistics(self, wall_clock_s: float,
                                 device: torch.device) -> str:
        stats: Dict[str, Any] = {"spent_time": round(wall_clock_s, 1)}
        if device.type == "cuda":
            stats["max_memory_GiB"] = round(
                torch.cuda.max_memory_allocated(device) / 2 ** 30, 2)
        path = self._path("training_statistics")
        if self.write:
            write_flat_yaml(path, stats)
        return path


    # -- checkpoints (runner.py:98-115) ------------------------------------------

    def checkpoint_path(self, name: str) -> str:
        return os.path.join(self.output_dir, f"{name}.pth")

    def save_checkpoint(self, state: Mapping[str, Any], name: str = "checkpoint") -> str:
        """``torch.save`` of ``state`` (tensors, state dicts, numbers) to
        ``<output_dir>/<name>.pth``, written whole before it replaces an
        older one."""
        path = self.checkpoint_path(name)
        if self.write:
            torch.save(dict(state), path + ".tmp")
            os.replace(path + ".tmp", path)
        return path

    def load_checkpoint(self, name: str = "checkpoint", map_location="cpu") -> Dict[str, Any]:
        return torch.load(self.checkpoint_path(name), map_location=map_location,
                          weights_only=False)


def _state_copy(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class TrainRunner(Runner):
    """Epoch-based training (RunnerBase.train, runner_base.py:360-417): per
    epoch a masked train pass, the evaluation of every valid split, the best
    checkpoint on the "val" split's ``agg_metrics``, and a train state that
    ``resume=True`` restores: the model, the optimizer state, the epoch and
    the best-checkpoint tracking (the reference's ``{model, optimizer,
    epoch}`` dict, runner_base.py:897-967)."""

    def __init__(self, output_dir: str = "output", job_id: str = "job",
                 max_epoch: int = 1, write: bool = True):
        super().__init__(output_dir, job_id, write)
        self.max_epoch = max_epoch
        self.best_agg = float("-inf")
        self.best_epoch = -1

    def save_train_state(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                         epoch: int, name: str = "train_state") -> str:
        return self.save_checkpoint({
            "model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "epoch": epoch, "best_agg": self.best_agg, "best_epoch": self.best_epoch,
        }, name)

    def load_train_state(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                         name: str = "train_state") -> int:
        """Restore model, optimizer and best tracking; returns the next
        epoch (_load_checkpoint, runner_base.py:945-967)."""
        dev = next(model.parameters()).device
        state = self.load_checkpoint(name, map_location=dev)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        self.best_agg = float(state["best_agg"])
        self.best_epoch = int(state["best_epoch"])
        return int(state["epoch"]) + 1

    def train(self, loss_fn: Callable, model: nn.Module,
              epoch_batches_fn: Callable[[int], Iterable[Any]], task=None,
              eval_data_fn: Optional[Callable[[], Any]] = None,
              optimizer: Optional[torch.optim.Optimizer] = None,
              masks: Optional[Dict[str, torch.Tensor]] = None,
              learning_rate: float = 1e-5, weight_decay: float = 0.05,
              resume: bool = False,
              valid_splits_fn: Optional[Callable[[], Mapping[str, Any]]] = None,
              test_splits_fn: Optional[Callable[[], Mapping[str, Any]]] = None,
              scheduler=None) -> Dict[str, torch.Tensor]:
        """Train ``model`` in place; ``epoch_batches_fn(epoch)`` gives an
        epoch's batches. Every valid split is evaluated each epoch and logged
        with ``best_epoch``; the best checkpoint keys on the "val" split
        alone (runner_base.py:393; without valid splits, on the train loss).
        After the last epoch the model holds the best weights, and
        ``test_splits_fn``'s splits are evaluated on them. ``eval_data_fn``
        is the one-split shorthand for ``{"val": eval_data_fn()}``. Returns
        the best state dict."""
        from ecoflap_tpu_torch.runners.finetune import adamw, make_sparsity_masks, train_step

        masks = masks if masks is not None else make_sparsity_masks(model)
        optimizer = optimizer or adamw(model, learning_rate, weight_decay)
        start_epoch = self.load_train_state(model, optimizer) if resume else 0
        best = _state_copy(model)
        if eval_data_fn is not None and valid_splits_fn is None:
            valid_splits_fn = lambda: {"val": eval_data_fn()}  # noqa: E731
        was_training = model.training
        model.requires_grad_(True)
        model.train(False)  # no dropout in the port's models; eval-mode numerics
        try:
            for epoch in range(start_epoch, self.max_epoch):
                losses = []
                for batch in epoch_batches_fn(epoch):
                    with torch.enable_grad():
                        losses.append(train_step(loss_fn, model, optimizer, masks, batch))
                    if scheduler is not None:
                        scheduler.step()
                train_metrics: Dict[str, Any] = {
                    "epoch": epoch, "train_loss": sum(losses) / max(len(losses), 1)}
                self.log_metrics(train_metrics, split="train")
                splits = valid_splits_fn() if (task is not None and valid_splits_fn) else {}
                if task is not None and valid_splits_fn and "val" not in splits:
                    logging.getLogger(__name__).warning(
                        "valid splits %s hold no 'val' entry: the best checkpoint "
                        "keys on 'val' only (runner_base.py:393)", sorted(splits))
                if not splits:
                    agg = -train_metrics["train_loss"]
                    if agg > self.best_agg:
                        self.best_agg, self.best_epoch = agg, epoch
                        best = _state_copy(model)
                        self.save_checkpoint({"model": best}, "checkpoint_best")
                for split_name, data in splits.items():
                    with torch.no_grad():
                        val_log = {**train_metrics, **task.evaluation(data)}
                    agg = val_log.get("agg_metrics", -val_log["train_loss"])
                    if split_name == "val" and agg > self.best_agg:
                        self.best_agg, self.best_epoch = agg, epoch
                        best = _state_copy(model)
                        self.save_checkpoint({"model": best}, "checkpoint_best")
                    val_log["best_epoch"] = self.best_epoch
                    self.log_metrics(val_log, split=split_name)
                self.save_train_state(model, optimizer, epoch)
        finally:
            model.requires_grad_(False)
            model.train(was_training)
        model.load_state_dict(best)
        if task is not None and test_splits_fn is not None:
            # the testing phase on the best weights (runner_base.py:411-417)
            with torch.no_grad():
                self.evaluate_splits(task, test_splits_fn(), cur_epoch=self.best_epoch)
        return best


class IterTrainRunner(TrainRunner):
    """Iteration-based training (RunnerIter, lavis/runners/runner_iter.py):
    inner "epochs" of ``iters_per_inner_epoch`` steps over an endless
    iterator."""

    def __init__(self, output_dir: str = "output", job_id: str = "job",
                 max_iters: int = 100, iters_per_inner_epoch: int = 10,
                 write: bool = True):
        super().__init__(output_dir, job_id,
                         max_epoch=max(1, max_iters // iters_per_inner_epoch),
                         write=write)
        self.iters_per_inner_epoch = iters_per_inner_epoch

    def train_iters(self, loss_fn: Callable, model: nn.Module,
                    infinite_batches: Iterable[Any], **kw) -> Dict[str, torch.Tensor]:
        it = iter(infinite_batches)

        def epoch_batches(_epoch):
            return [next(it) for _ in range(self.iters_per_inner_epoch)]

        return self.train(loss_fn, model, epoch_batches, **kw)


def global_sparsity(weights) -> float:
    """sum(w == 0) / sum(numel) over the given tensors (evaluate_blip.py:432-436)."""
    zeros = total = 0
    for w in weights:
        zeros += int((w == 0).sum())
        total += w.numel()
    return zeros / max(total, 1)
