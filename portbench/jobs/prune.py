"""Prune jobs: the window runs whole ECoFLaP prune jobs back to back.

Set-up builds the program's model at the configuration's sizes with no
initialisation, copies in the seed's weights (``weights.make``; that dict
stays as the dense copy), makes the calibration batch, and runs one whole
job to warm every shape the jobs use. Each job restores the weights it
prunes from the dense copy with ``copy_``, builds a fresh pruner through
``pruning.loader.load_pruner`` and calls ``prune()`` under ``no_grad``, as
the prune CLI does. A job starts only if the last one's duration says it
would end inside the window; at least one always runs.

What is judged, of the window's last job:

* the coarse stage (MeZO), before a difference of two losses cancels what
  it computed: for ``LANE_TARGETS`` targets of each pruned stack drawn from
  the seed, ``LANE_ENTRIES`` entries of kernel 2's perturbed weights
  W +- eps z, and every per-sample
  loss that the lane ensemble computed at them (``LaneProbe`` records both
  as the window runs); the reference draws z itself and computes the
  losses of the whole model with that one weight perturbed;
* the sparsity dict, against the reference's allocation of the program's
  scores;
* every pruned weight: the reference's fine stage, from the dense weights
  and the program's dict, block by block.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, weights
from portbench.reference import allocator, fine, mezo
from portbench.reference import blip2_t5 as R
from portbench.reference.numerics import Prec

LANE_TARGETS = 2  # sampled targets per pruned stack in the coarse check
LANE_ENTRIES = 65536  # entries compared of each sampled perturbed weight


class Job:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.records: List[Dict] = []
        self.jobs_run = 0

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from ecoflap_tpu_torch.pruning.loader import load_pruner

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        self._load_pruner = load_pruner
        fam = ctx.family()
        self.model, self.adapter = fam.build(cfg, ctx.device, ctx.dtype)
        self.dense = weights.make(weights.param_list(self.model), cfg["init"], ctx.seed,
                                  ctx.device)
        weights.load(self.model, self.dense)
        self.copy_bytes = sum(t.numel() * t.element_size() for t in self.dense.values())
        self.batch = fam.calibration(cfg, mix, ctx.seed, ctx.device)
        specs = mix["stack_specs"]
        self.pruned = [s for s in self.adapter.stacks if specs.get(s.name)]
        self.targets = [t for t in self.adapter.targets() if t.stack in self.pruned]
        self.params = {t.name: t.weight(self.model) for t in self.targets}
        self.pruner_cfg = dict(
            stack_specs=specs, prune_spec=None,
            sparsity_ratio_granularity=mix["sparsity_ratio_granularity"],
            max_sparsity_per_layer=mix["max_sparsity_per_layer"],
            score_method=mix["score_method"],
            num_data_first_stage=mix["num_data_first_stage"],
            num_noise=mix["num_noise"], noise_eps=mix["noise_eps"],
            noise_mode=mix["noise_mode"], mezo_ensemble=mix["mezo_ensemble"],
            seed=ctx.seed, verbose=False)
        self.num_microbatches = mix["num_samples"] // mix["batch_size"]
        self.probe = None
        if mix["score_method"].startswith("MEZO"):
            self.probe = LaneProbe(self.lane_checks())
            self.probe.install()
        self.run_job()  # warm-up: every shape of the jobs

    @torch.no_grad()
    def restore(self) -> None:
        for name, p in self.params.items():
            p.copy_(self.dense[name])

    def run_job(self) -> None:
        from torch.profiler import record_function

        t0 = time.time()
        if self.probe is not None:
            self.probe.reset()
        with record_function("portbench.restore"):
            self.restore()
        with record_function("portbench.prune"), torch.no_grad():
            pruner = self._load_pruner(self.mix["pruning_method"], self.adapter, self.batch,
                                       self.num_microbatches, self.pruner_cfg)
            _, sdict = pruner.prune()
        self.ctx.sync()
        self.records.append({"s": time.time() - t0, "phase_times": dict(pruner.phase_times)})
        self.last = {"scores": dict(pruner.leaf_scores),
                     "dict": None if sdict is None else {t.name: float(sdict[t.name])
                                                         for t in self.targets}}

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Whole jobs for ``seconds``; returns {seconds, work, records}."""
        self.records = []
        start = time.time()
        while not self.records or (time.time() - start + self.records[-1]["s"] <= seconds):
            self.run_job()
        self.jobs_run += len(self.records)
        return {"seconds": time.time() - start, "work": len(self.records),
                "records": self.records}

    def end_to_end(self, timed: Dict) -> Dict[str, float]:
        return {"prune_s": timed["seconds"] / timed["work"],
                "peak_gib": (self.ctx.window_peak - self.copy_bytes) / 2 ** 30}

    def counts(self) -> Dict:
        out = {"flops_per_job": counts.blip2_prune_job_flops(self.cfg, self.mix)}
        if self.mix["score_method"].startswith("MEZO"):
            out["perturb"] = counts.blip2_perturb_bound_s(self.cfg, self.mix)
        return out

    @property
    def attempted(self) -> int:
        return self.jobs_run

    def lane_checks(self) -> List["LaneCheck"]:
        """The coarse stage's sampled checks: per pruned stack
        ``LANE_TARGETS`` targets drawn from the seed, each with every coarse
        microbatch, and the entries of its weight to compare."""
        rng = np.random.default_rng([self.ctx.seed, 7])
        names = [t.name for t in self.targets]
        out = []
        for stack in self.pruned:
            idx = [i for i, n in enumerate(names) if n.startswith(stack.name + ".")]
            for i in sorted(rng.choice(idx, size=min(LANE_TARGETS, len(idx)),
                                       replace=False).tolist()):
                numel = self.dense[names[i]].numel()
                entries = np.sort(rng.choice(numel, size=min(numel, LANE_ENTRIES), replace=False))
                for b in range(self.coarse_microbatches()):
                    out.append(LaneCheck(names[i], i, b, mezo.kernel_seed(self.ctx.seed, i, b),
                                         torch.as_tensor(entries, device=self.ctx.device)))
        return out

    def coarse_microbatches(self) -> int:
        """The pruner's: the first ``num_data_first_stage`` samples in whole
        microbatches, at least one."""
        b = self.mix["batch_size"]
        return max(1, min(self.mix["num_data_first_stage"], self.mix["num_samples"]) // b)

    # -- correctness ---------------------------------------------------------
    def release(self) -> None:
        """Free the program's state, keeping the last job's outputs: its
        scores, its dict, what the probe recorded of its coarse stage and
        the pruned weights."""
        self.outputs = {"scores": self.last["scores"], "dict": self.last["dict"],
                        "weights": {n: p.detach() for n, p in self.params.items()}}
        if self.probe is not None:
            self.probe.uninstall()
            self.outputs["lanes"] = self.probe.recorded()
        del self.adapter
        self.model = None
        torch.cuda.empty_cache()

    def program_outputs(self) -> Dict:
        return self.outputs

    @torch.no_grad()
    def reference_outputs(self, prec: Prec, dict_from: Dict = None,
                          follow: Dict = None) -> Dict:
        """What the reference computes in ``prec``: the sampled lane checks
        (``reference_lanes``), and each block's pruned weights with the dict ``dict_from``
        (the judged run's, judged on its own), from the dense weights, or,
        with ``follow``, from the state the judged run's pruned weights
        ``follow`` reached before that block."""
        out: Dict = {}
        if self.probe is not None:
            out["lanes"] = self.reference_lanes(prec)
        out["weights"] = self.reference_fine(
            prec, dict_from if dict_from is not None else self.ratios(), follow)
        return out

    def reference_lanes(self, prec: Prec) -> Dict:
        """Per lane check and sign: the perturbed weight's sampled entries
        (W +- eps z in float32, rounded once to the weight's dtype, then in
        the control through fp8) and the microbatch's per-sample losses of
        the whole model with that weight perturbed."""
        cfg, mix, b = self.cfg, self.mix, self.mix["batch_size"]
        out = {}
        for c in self.probe.checks:
            mb = R.slice_batch(self.batch, c.batch * b, (c.batch + 1) * b)
            for sign in (1, -1):
                wp = mezo.perturbed(self.dense[c.name], c.seed, sign * mix["noise_eps"])
                losses = R.per_sample_loss({**self.dense, c.name: wp}, cfg, prec, mb)
                out[c.key(sign)] = {"entries": prec.q(wp).reshape(-1)[c.entries],
                                    "losses": losses}
        return out

    def reference_fine(self, prec: Prec, ratios: Dict, follow: Dict = None
                       ) -> Dict[str, torch.Tensor]:
        cfg, mix = self.cfg, self.mix
        W = dict(self.dense)
        b, n_all = mix["batch_size"], mix["num_samples"]
        mbs = [R.slice_batch(self.batch, i, i + b) for i in range(0, n_all, b)]
        qe, out = None, {}
        self.losses = {}
        method = "sparsegpt" if mix["pruning_method"].endswith("sparsegpt_pruner") else "wanda"
        for stack in self.pruned:
            s = stack.name
            if s != R.VIT and qe is None:
                qe = [R.project(W, cfg, prec, R.vit(W, cfg["vit"], prec, mb["image"]))
                      for mb in mbs]
            inputs = [R.stack_inputs(W, cfg, prec, s, mb, None if qe is None else qe[j])
                      for j, mb in enumerate(mbs)]
            block = R.stack_block(s)
            out.update(fine.prune_stack(
                W, lambda i, s=s: [(ln, R.weight_key(s, i, ln)) for ln in R.STACK_LINEARS[s]],
                R.depth(cfg, s), lambda i, x, c, st, md, block=block: block(
                    W, cfg, prec, i, x, c, st, md),
                inputs, ratios, method, R.PER_ROW[s], float(n_all), follow,
                self.sample_blocks(s) if method == "sparsegpt" else None, self.losses))
        return out

    def sample_blocks(self, stack: str):
        """SparseGPT's sweep is sequential column by column; the reference
        sweeps the mix's count of blocks per stack, drawn from the seed
        (block 0 always), and only runs the others."""
        k = self.mix["check"]["sparsegpt_blocks"]
        rng = np.random.default_rng([self.ctx.seed, 13])
        rest = rng.choice(np.arange(1, R.depth(self.cfg, stack)), size=k - 1, replace=False)
        return {0, *rest.tolist()}

    def as_program(self, ctrl: Dict, ref: Dict) -> Dict:
        """The control's outputs in the program's place: its lane checks and
        its pruned weights (it has no dict of its own: it scores no target
        but the sampled ones)."""
        return {"lanes": ctrl.get("lanes"), "dict": None, "weights": ctrl["weights"]}

    def ratios(self) -> Dict[str, float]:
        """The program's per-weight ratios, or the mix's uniform one."""
        if self.outputs["dict"] is not None:
            return self.outputs["dict"]
        from portbench.harness import spec_sparsity

        return {t.name: spec_sparsity(self.mix["stack_specs"][t.stack.name])
                for t in self.targets}

    def judge(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """The numbers compared, program against reference (``detail``
        keeps what they were taken from, for the readings)."""
        out: Dict[str, float] = {}
        self.detail: Dict = {}
        if "lanes" in ref:
            # noise_gap: the share of kernel 2's sampled entries unlike the
            # reference's W +- eps z; lane_loss_gap: the widest gap between a
            # lane's per-sample loss and the reference's, in nats
            lanes = prog.get("lanes") or {}
            noise, gaps = [], []
            for key, r in ref["lanes"].items():
                p = lanes.get(key)
                if p is None or p["losses"].shape != r["losses"].shape:
                    noise.append(math.inf)
                    gaps.append(math.inf)
                    continue
                noise.append(float((p["entries"].float() != r["entries"].float())
                                   .float().mean()))
                gaps.append(float((p["losses"].float() - r["losses"].float()).abs().max()))
            self.detail["lane_loss_gap"] = {"/".join(map(str, k)): g
                                            for k, g in zip(ref["lanes"], gaps)}
            out["noise_gap"] = max(noise)
            out["lane_loss_gap"] = max(gaps)
        if prog.get("dict") is not None:
            numels = {t.name: self.dense[t.name].numel() for t in self.targets}
            if set(numels) <= set(prog.get("scores") or {}):
                want = allocator.block_sparsity(
                    {n: prog["scores"][n] for n in numels}, numels,
                    _target_sparsity(self.mix), self.mix["max_sparsity_per_layer"])
                out["dict_gap"] = max(abs(prog["dict"].get(n, math.inf) - want[n])
                                      for n in numels)
            else:
                out["dict_gap"] = math.inf
        sparsegpt = self.mix["pruning_method"].endswith("sparsegpt_pruner")
        mask_gaps, kept_changed, share_gaps = [], 0, []
        ratios = self.ratios() if prog.get("dict") is None else prog["dict"]
        for n, w in prog["weights"].items():
            pm = w == 0
            if sparsegpt:
                # every weight: its zeros against the share SparseGPT's
                # per-128-column mask gives
                share_gaps.append(abs(float(pm.float().mean()) - _sparsegpt_share(
                    w.shape, ratios[n])))
            if n not in ref["weights"]:
                continue
            f = int((pm ^ (ref["weights"][n] == 0)).sum())
            mask_gaps.append(f / w.numel())
            stack = next(st.name for st in self.pruned if n.startswith(st.name + "."))
            by_stack = self.detail.setdefault("mask_gap_by_stack", {})
            by_stack[stack] = max(by_stack.get(stack, 0.0), f / w.numel())
            if not sparsegpt:
                kept_changed += int(((~pm) & (w != self.dense[n])).sum())
        if sparsegpt:
            # SparseGPT's masks differ where a sweep's greedy choices do:
            # kept for the readings, not compared
            self.detail["mask_gap"] = max(mask_gaps)
            # SparseGPT's layer loss under the reference's Gram matrix, of the
            # mix's linears: the LayerNorm-fed qkv and fc1 have a Gram matrix
            # close to singular, where the sweep swings on both sides
            losses = getattr(self, "losses", {})
            self.detail["layer_loss"] = {k: list(v) for k, v in losses.items()}
            kept = [v for k, v in losses.items()
                    if any(k.endswith(f".{ln}.weight") for ln in self.mix["check"]["loss_linears"])]
            out["loss_gap"] = max((abs(p / r - 1.0) if r > 0 else math.inf)
                                  for p, r in kept) if kept else math.inf
            out["share_gap"] = max(share_gaps)
        else:
            out["mask_gap"] = max(mask_gaps)
            out["kept_changed"] = float(kept_changed)
        return out


def _sparsegpt_share(shape, ratio: float, blocksize: int = 128) -> float:
    """Zeros SparseGPT leaves in an (out, in) weight: in each block of up to
    128 columns, the entries at or under the floor(n r)-th smallest
    saliency, ties aside."""
    from portbench.reference.fine import floor_count

    rows, cols = shape
    zeros = 0
    for i1 in range(0, cols, blocksize):
        n = rows * (min(i1 + blocksize, cols) - i1)
        zeros += min(max(floor_count(n, ratio), 0), n - 1) + 1
    return zeros / (rows * cols)


def _target_sparsity(mix: Dict) -> float:
    from portbench.harness import spec_sparsity

    return spec_sparsity(next(s for s in mix["stack_specs"].values() if s))


class LaneCheck:
    """One sampled target and coarse microbatch: the kernel seed of its
    noise and the entries of its weight that are compared."""

    def __init__(self, name: str, index: int, batch: int, seed: int,
                 entries: torch.Tensor) -> None:
        self.name, self.index, self.batch, self.seed = name, index, batch, seed
        self.entries = entries

    def key(self, sign: int):
        return (self.name, self.batch, sign)


class LaneProbe:
    """Records what the lane ensemble computes for the sampled checks, as
    the window runs: the sampled entries of each perturbed weight that
    kernel 2 (``pruning.mezo.perturb``) returns for a check's seed, and the
    per-sample losses that ``SuffixPlan.lane_losses`` returns in that
    weight's lane. Both are wrapped, calling through to the program; a
    perturbed weight is matched to its lane by identity."""

    def __init__(self, checks: List[LaneCheck]) -> None:
        self.checks = checks
        self.by_seed = {c.seed: c for c in checks}
        self.reset()

    def reset(self) -> None:
        self.entries: Dict = {}
        self.losses: Dict = {}
        self.pending: Dict[int, tuple] = {}

    def install(self) -> None:
        from ecoflap_tpu_torch.pruning import mezo as program_mezo
        from ecoflap_tpu_torch.pruning import plans

        self._mezo, self._plan = program_mezo, plans.SuffixPlan
        self._perturb, self._lane_losses = program_mezo.perturb, plans.SuffixPlan.lane_losses
        probe = self

        def perturb(w, seed, scale):
            out = probe._perturb(w, seed, scale)
            c = probe.by_seed.get(seed)
            if c is not None:
                key = c.key(1 if scale > 0 else -1)
                probe.entries[key] = out.reshape(-1)[c.entries]
                probe.pending[id(out)] = key
            return out

        def lane_losses(plan, model, data, paths, weights):
            out = probe._lane_losses(plan, model, data, paths, weights)
            for k, w in enumerate(weights):
                key = probe.pending.pop(id(w), None)
                if key is not None:
                    probe.losses[key] = out[k].detach().clone()
            return out

        program_mezo.perturb, plans.SuffixPlan.lane_losses = perturb, lane_losses

    def uninstall(self) -> None:
        self._mezo.perturb, self._plan.lane_losses = self._perturb, self._lane_losses

    def recorded(self) -> Dict:
        """{check key: {entries, losses}} of the last job, for each key that
        has both."""
        return {k: {"entries": e, "losses": self.losses[k]}
                for k, e in self.entries.items() if k in self.losses}
