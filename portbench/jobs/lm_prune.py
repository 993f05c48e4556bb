"""Decoder-LM prune jobs (LFM2-MoE): the window runs whole first-order
ECoFLaP + Wanda prune jobs back to back.

Set-up, the restores, the window and the job loop are ``jobs/prune.py``'s
(``Job`` below extends it): the program's model at the configuration's
sizes, the seed's weights (the dict stays as the dense copy; each
``expert_bias`` buffer is drawn with them), the calibration windows, one
warm-up job; each job restores its targets from the dense copy, builds a
fresh pruner through ``load_pruner`` and prunes under ``no_grad``.

``Probe`` records, as the window runs, what the program computes that a
check needs besides its outputs: the sampled gradient entries that
``pruning.first_order._target_grads`` yields for the checked weights, and
the experts each sparse layer's ``SparseMoe.route`` chose, call by call.
Routing is a discrete choice: where a near tie between two experts falls
one way in bfloat16 and the other in float32, a token's whole expert
changes, and those flips would swamp every other gap of the experts'
gradients and masks. So the reference judges the routing on its own
(``route_gap``) and, to judge the rest, uses the routing of the run it
follows (the program's, or the control's).

What is judged, of the window's last job:

* ``route_gap``: the largest share, over the sparse layers, of the tokens
  whose set of experts is not the float32 reference's own choice on the
  same windows and weights (in the reference's forwards of the coarse check
  and of the fine check, each following the judged run's state; the hidden
  states are the reference's own).
* ``grad_gap``: the coarse stage's first-order gradients, entry by entry.
  For two blocks drawn from the seed (an attention block and a
  short-convolution block), ``GRAD_ENTRIES`` entries of every target drawn
  from the seed: the sum over the coarse microbatches of |g|, g the
  gradient of the microbatch's mean loss (``GradOnly``'s statistic before it
  is summed over the weight). The reference's come from plain autograd of
  its whole-model float32 loss, window by window (the gradient of a
  microbatch's mean is the mean of its windows' gradients). The largest
  ||G_prog - G_ref|| / ||G_ref|| of one weight.
* ``dict_gap``: the sparsity dict against the reference allocator on the
  program's own scores.
* ``mask_gap``: the largest share of one weight's Wanda mask unlike the
  reference's, the reference following the program's pruned state block by
  block.
* ``kept_changed``: kept weights that are not the dense ones.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import counts_lm, weights
from portbench.harness import load_file
from portbench.reference import allocator, fine
from portbench.reference import lfm2_moe as R
from portbench.reference.numerics import Prec

_prune = load_file(Path(__file__).resolve().parent / "prune.py")

REF_CHUNK = 4  # windows a reference forward takes in the fine check
GRAD_CHUNK = 1  # windows a reference backward takes in the coarse check
GRAD_ENTRIES = 65536  # entries compared of each checked weight (all of a smaller one)
ROUTES = "routes"  # the key of a run's routing beside its pruned weights


def is_expert(name: str) -> bool:
    return ".experts." in name


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r||; 0 where both are zero, inf where only r is."""
    num = float(torch.linalg.vector_norm(p.to(r.device, torch.float64) - r.to(torch.float64)))
    den = float(torch.linalg.vector_norm(r.to(torch.float64)))
    if den == 0:
        return 0.0 if num == 0 else math.inf
    return num / den


def differ(own: torch.Tensor, given: torch.Tensor) -> int:
    """Tokens whose set of k experts differs."""
    a = own.sort(dim=-1).values
    b = given.to(own.device, torch.long).sort(dim=-1).values
    return int((a != b).any(dim=-1).sum())


class Probe:
    """What the program computes for the checks, recorded as the window
    runs; the wrapped functions return what the program's return."""

    def __init__(self, entries: Dict[str, torch.Tensor], layers: Dict[int, int]) -> None:
        self.entries = entries  # {weight key: flat indices}
        self.layers = layers  # {id(SparseMoe): layer index}
        self.reset()

    def reset(self) -> None:
        self.sums: Dict[str, torch.Tensor] = {}
        self.calls: Dict[int, List[torch.Tensor]] = {}

    def install(self) -> None:
        from ecoflap_tpu_torch.models import lfm2_moe
        from ecoflap_tpu_torch.pruning import first_order

        self._fo, self._target_grads = first_order, first_order._target_grads
        self._moe, self._route = lfm2_moe.SparseMoe, lfm2_moe.SparseMoe.route
        probe = self

        def target_grads(*a, **kw):
            for name, w, g in probe._target_grads(*a, **kw):
                idx = probe.entries.get(name)
                if idx is not None:
                    s = g.reshape(-1).index_select(0, idx).to(torch.float32).abs()
                    probe.sums[name] = probe.sums[name] + s if name in probe.sums else s
                yield name, w, g

        def route(moe, flat):
            sel, wts = probe._route(moe, flat)
            probe.calls.setdefault(probe.layers[id(moe)], []).append(sel.to(torch.uint8))
            return sel, wts

        first_order._target_grads, lfm2_moe.SparseMoe.route = target_grads, route

    def uninstall(self) -> None:
        self._fo._target_grads, self._moe.route = self._target_grads, self._route

    def routes(self, coarse_mb: int, coarse_windows: int, windows: int, seq: int
               ) -> Optional[Dict]:
        """{layer: {pass: (windows, S, k) experts}}: each coarse
        microbatch's forward (its per-block recompute chooses the same
        again), then the fine stage's statistics pass and re-forward, chunk
        by chunk; None where the calls do not make those windows."""
        out = {}
        for i, calls in self.calls.items():
            c, odd = divmod(len(calls) - 2 * coarse_mb, 2)
            if c <= 0 or odd:
                return None
            parts = {"coarse": calls[:2 * coarse_mb:2],
                     "collect": calls[2 * coarse_mb:2 * coarse_mb + c],
                     "reforward": calls[2 * coarse_mb + c:]}
            out[i] = {k: torch.cat(v).view(-1, seq, v[0].shape[-1]) for k, v in parts.items()}
            if [v.shape[0] for v in out[i].values()] != [coarse_windows, windows, windows]:
                return None
        return out


class Job(_prune.Job):
    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from ecoflap_tpu_torch.pruning.loader import load_pruner

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        self._load_pruner = load_pruner
        fam = ctx.family()
        self.model, self.adapter = fam.build(cfg, ctx.device, ctx.dtype)
        self.dense = weights.make(weights.param_list(self.model)
                                  + fam.buffer_list(self.model, ctx.dtype),
                                  cfg["init"], ctx.seed, ctx.device)
        weights.load(self.model, self.dense)
        fam.load_buffers(self.model, self.dense)
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
            num_data_first_stage=mix["num_data_first_stage"], seed=ctx.seed,
            verbose=False)
        self.num_microbatches = mix["num_samples"] // mix["batch_size"]
        layers = {id(blk.feed_forward): i for i, blk in enumerate(self.model.model.layers)
                  if R.sparse(cfg, i)}
        self.probe = Probe(self.grad_entries(), layers)
        self.probe.install()
        self.run_job()  # warm-up: every shape of the jobs

    def counts(self) -> Dict:
        return {"flops_per_job": counts_lm.lm_prune_job_flops(self.cfg, self.mix)}

    def check_blocks(self) -> List[int]:
        """The coarse check's blocks, drawn from the seed: one attention
        block and one short-convolution block."""
        rng = np.random.default_rng([self.ctx.seed, 17])
        kinds = self.cfg["layer_types"]
        attn = [i for i, k in enumerate(kinds) if k == R.ATTN]
        conv = [i for i, k in enumerate(kinds) if k != R.ATTN]
        return sorted([int(rng.choice(attn)), int(rng.choice(conv))])

    def grad_entries(self) -> Dict[str, torch.Tensor]:
        """{weight key: sorted flat indices} of the check blocks' targets,
        ``GRAD_ENTRIES`` of each drawn from the seed."""
        rng = np.random.default_rng([self.ctx.seed, 18])
        out = {}
        for i in self.check_blocks():
            for ln in R.block_linears(self.cfg, i):
                k = R.weight_key(i, ln)
                n = self.dense[k].numel()
                idx = np.sort(rng.choice(n, min(n, GRAD_ENTRIES), replace=False))
                out[k] = torch.from_numpy(idx).to(self.ctx.device)
        return out

    # -- correctness ---------------------------------------------------------
    def release(self) -> None:
        """Free the program's state, keeping the last job's scores, dict,
        recorded gradient entries and routing, and pruned weights."""
        self.probe.uninstall()
        ids = self.batch["input_ids"]
        _, b = self._coarse()
        routes = self.probe.routes(self.coarse_microbatches(), self.coarse_microbatches() * b,
                                   ids.shape[0], ids.shape[1])
        self.outputs = {"scores": self.last["scores"], "dict": self.last["dict"],
                        "grads": dict(self.probe.sums),
                        "weights": {**{n: p.detach() for n, p in self.params.items()},
                                    ROUTES: routes}}
        del self.adapter
        self.model = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @torch.no_grad()
    def reference_outputs(self, prec: Prec, dict_from: Dict = None,
                          follow: Dict = None) -> Dict:
        """What the reference computes in ``prec``: the check blocks'
        gradient statistics (``grads``: each weight's ``GradOnly`` sum and
        its sampled entries) and every weight's Wanda mask (``weights``,
        True = pruned, and under ``ROUTES`` the reference's own routing)
        with the dict ``dict_from``, from the dense weights or, with
        ``follow``, from the state the judged run's pruned weights (or
        masks) ``follow`` reached before each block, and with its routing
        (``route_gap``: its largest share of tokens routed otherwise than
        the reference's own choice; inf where it has none)."""
        ratios = dict_from if dict_from is not None else self.outputs["dict"]
        given = None if follow is None else follow.get(ROUTES)
        log = Routing(given, self.batch["input_ids"].shape[1])
        out = {"grads": self.reference_grads(prec, log),
               "weights": self.reference_fine(prec, ratios, follow, log)}
        out["weights"][ROUTES] = log.own()
        if follow is not None:
            out["route_gap"] = log.gap()
        return out

    def _coarse(self):
        b = self.mix["batch_size"]
        return self.batch["input_ids"][:self.coarse_microbatches() * b], b

    @torch.enable_grad()
    def reference_grads(self, prec: Prec, log: "Routing") -> Dict[str, Dict]:
        """{"sums": {key: GradOnly sum}, "entries": {key: the sampled
        entries' sum of |g| over the microbatches}} of the check blocks."""
        cfg = self.cfg
        ids, b = self._coarse()
        W = dict(self.dense)
        idx = self.grad_entries()
        keys = list(idx)
        leaves = {k: W[k].to(torch.float32).requires_grad_(True) for k in keys}
        W.update(leaves)
        sums = {k: torch.zeros((), dtype=torch.float64, device=ids.device) for k in keys}
        entries = {k: torch.zeros(len(idx[k]), device=ids.device) for k in keys}
        for m in range(0, ids.shape[0], b):
            g = {k: torch.zeros_like(v) for k, v in leaves.items()}
            for c in range(m, m + b, GRAD_CHUNK):
                seen: Dict[int, List] = {}
                loss = R.per_sample_loss(W, cfg, prec, ids[c:c + GRAD_CHUNK],
                                         log.given("coarse", c, GRAD_CHUNK), seen).sum() / b
                log.saw("coarse", c, seen)
                parts = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                for k, gk in zip(keys, parts):
                    if gk is not None:
                        g[k] += gk
            for k in keys:
                sums[k] += g[k].abs().sum(dtype=torch.float64)
                entries[k] += g[k].reshape(-1)[idx[k]].abs()
        mb = ids.shape[0] // b
        return {"sums": {k: float(v) / mb for k, v in sums.items()}, "entries": entries}

    def reference_fine(self, prec: Prec, ratios: Dict, follow: Dict, log: "Routing"
                       ) -> Dict[str, torch.Tensor]:
        """Wanda block by block (``fine.wanda_mask`` per row, the statistic
        over all calibration windows), each block re-run with the pruned
        weights, or those ``follow`` gives, to make the next block's
        inputs; returns the masks."""
        cfg, ids = self.cfg, self.batch["input_ids"]
        W = dict(self.dense)
        cache = R.rope(cfg, ids.shape[1], ids.device)
        starts = range(0, ids.shape[0], REF_CHUNK)
        xs = [R.embed(W, ids[c:c + REF_CHUNK]) for c in starts]
        masks: Dict[str, torch.Tensor] = {}
        n = float(ids.shape[0])
        for i in range(cfg["num_hidden_layers"]):
            stats: Dict[str, torch.Tensor] = {}
            for c, x in zip(starts, xs):
                seen: Dict[int, List] = {i: []}
                R.block(W, cfg, prec, i, x, cache, stats, "wanda",
                        log.given("collect", c, REF_CHUNK, i), seen[i])
                log.saw("collect", c, seen)
            keys = [(ln, R.weight_key(i, ln)) for ln in R.block_linears(cfg, i)]
            for ln, key in keys:
                m = fine.wanda_mask(W[key], stats[ln], n, ratios[key], per_row=True)
                masks[key] = m
                if follow is None:
                    W[key] = W[key].masked_fill(m, 0)
                else:
                    f = follow[key]
                    W[key] = self.dense[key].masked_fill(f, 0) if f.dtype == torch.bool else f
            del stats
            for j, (c, x) in enumerate(zip(starts, xs)):
                seen = {i: []}
                xs[j] = R.block(W, cfg, prec, i, x, cache,
                                given=log.given("reforward", c, REF_CHUNK, i), seen=seen[i])
                log.saw("reforward", c, seen)
            for _, key in keys:  # the block has run; its pruned weights are done with
                W[key] = self.dense[key]
        return masks

    def as_program(self, ctrl: Dict, ref: Dict) -> Dict:
        """The control's outputs in the program's place: its gradient
        statistics of the check blocks and its masks (it has no dict of its
        own)."""
        return {"scores": ctrl["grads"]["sums"], "grads": ctrl["grads"]["entries"],
                "dict": None, "weights": ctrl["weights"]}

    def judge(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        out: Dict[str, float] = {"route_gap": ref.get("route_gap", math.inf)}
        self.detail: Dict = {}
        scores = prog.get("scores") or {}
        got = prog.get("grads") or {}
        grad = {k: (rel_gap(got[k], r) if k in got else math.inf)
                for k, r in ref["grads"]["entries"].items()}
        self.detail["grad_gap"] = dict(sorted(grad.items(), key=lambda kv: -kv[1])[:8])
        out["grad_gap"] = max(grad.values())
        if prog.get("dict") is not None:
            numels = {t.name: self.dense[t.name].numel() for t in self.targets}
            if set(numels) <= set(scores):
                want = allocator.block_sparsity(
                    {n: scores[n] for n in numels}, numels,
                    _prune._target_sparsity(self.mix), self.mix["max_sparsity_per_layer"])
                out["dict_gap"] = max(abs(prog["dict"].get(n, math.inf) - want[n])
                                      for n in numels)
            else:
                out["dict_gap"] = math.inf
        mask_gap, kept_changed, by_kind = 0.0, 0, {}
        for n, w in prog["weights"].items():
            if n == ROUTES:
                continue
            pm = w if w.dtype == torch.bool else w == 0
            rm = ref["weights"].get(n)
            share = math.inf if rm is None else float((pm ^ rm).sum()) / w.numel()
            mask_gap = max(mask_gap, share)
            kind = n.split(".")[-2] if not is_expert(n) else "expert." + n.split(".")[-2]
            by_kind[kind] = max(by_kind.get(kind, 0.0), share)
            if w.dtype != torch.bool:
                kept_changed += int(((~pm) & (w != self.dense[n])).sum())
        self.detail["mask_gap_by_linear"] = by_kind
        out["mask_gap"] = mask_gap
        out["kept_changed"] = float(kept_changed)
        return out


class Routing:
    """The routing a reference computation follows (``given``: {layer:
    {pass: (windows, S, k) experts}}, or None for its own), its own choices
    in the same form, and by layer its tokens routed otherwise than its own
    choice."""

    def __init__(self, given: Optional[Dict], seq: int) -> None:
        self._given, self.seq = given, seq
        self._own: Dict[int, Dict[str, Dict[int, torch.Tensor]]] = {}
        self.diff: Dict[int, int] = {}
        self.tokens: Dict[int, int] = {}

    def given(self, pas: str, start: int, count: int, layer: Optional[int] = None):
        """The followed experts of windows [start, start + count) as (tokens,
        k), of ``layer``, or as {layer: ...}; None: the reference's own."""
        if self._given is None:
            return None
        if layer is not None:
            r = self._given.get(layer)
            return None if r is None else r[pas][start:start + count].flatten(0, 1)
        return {i: r[pas][start:start + count].flatten(0, 1) for i, r in self._given.items()}

    def saw(self, pas: str, start: int, seen: Dict[int, List[torch.Tensor]]) -> None:
        """Keep each sparse layer's own choice for the windows from
        ``start``; count its tokens routed otherwise by the followed run."""
        for i, own in seen.items():
            for sel in own:  # one call a sparse layer
                self._own.setdefault(i, {}).setdefault(pas, {})[start] = sel.to(torch.uint8)
                if self._given is None:
                    continue
                g = self.given(pas, start, sel.shape[0] // self.seq, i)
                self.diff[i] = self.diff.get(i, 0) + (sel.shape[0] if g is None
                                                      else differ(sel, g))
                self.tokens[i] = self.tokens.get(i, 0) + sel.shape[0]

    def own(self) -> Dict:
        """The reference's own routing, in the form it follows."""
        return {i: {pas: torch.cat([parts[s] for s in sorted(parts)]).view(
                        -1, self.seq, parts[min(parts)].shape[-1])
                    for pas, parts in by_pass.items()}
                for i, by_pass in self._own.items()}

    def gap(self) -> float:
        """The largest share of a sparse layer's tokens routed otherwise."""
        if self._given is None or not self.tokens:
            return math.inf
        return max(self.diff[i] / self.tokens[i] for i in self.tokens)
