"""Zero-shot classification: the window runs batches closed-loop through
the evaluate CLI's ``zero_shot_predict_fn`` on numpy batches, as the CLI
does; each batch's host-to-device copy is part of it, and the next batch
starts when its logits are on the card.

Set-up builds the program's model with no initialisation, copies in the
seed's weights with the visual tower's block linears zeroed to the mix's
share by each weight's own magnitude (so the window evaluates a pruned
model), builds the prompt-ensemble classifier through
``CLIP.zero_shot_classifier`` and warms one batch. The weights' dict is
dropped once copied, and made again from the seed for the reference.

What is judged: the float32 logits of every batch of the window, every
image, against a sample of classes drawn from the seed, which the
reference computes from the same weights and prompts (its own classifier,
its own visual tower).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, weights
from portbench.reference import eva_clip as R
from portbench.reference.numerics import Prec


class Job:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.outs: List = []

    def _weights(self, params) -> Dict[str, torch.Tensor]:
        w = weights.make(params, self.cfg["init"], self.ctx.seed, self.ctx.device)
        weights.magnitude_prune_(w, self.fam.visual_linears(self.cfg),
                                 self.mix["visual_magnitude_sparsity"])
        return w

    def setup(self) -> None:
        from ecoflap_tpu_torch.cli.evaluate import zero_shot_predict_fn

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        self.fam = ctx.family()
        self.model = self.fam.build(cfg, ctx.device, ctx.dtype)
        self.params = weights.param_list(self.model)
        w = self._weights(self.params)
        weights.load(self.model, w)
        del w
        self.prompt_ids = self.fam.prompts(cfg, mix, ctx.seed, ctx.device)
        c, k, n = self.prompt_ids.shape
        classifier = self.model.zero_shot_classifier(self.prompt_ids.reshape(c * k, n), c)
        self.batches = self.fam.images(cfg, mix, ctx.seed, ctx.device)
        self.predict = zero_shot_predict_fn(self.model, classifier, ctx.device)
        self.predict({"image": self.batches[0]})  # warm-up: the one shape
        ctx.sync()

    def window(self, seconds: float) -> Dict:
        """Batches for ``seconds``; returns {seconds, work: images}. Every
        batch's logits are kept for the check, those of earlier windows too."""
        from torch.profiler import record_function

        start, last, n = time.time(), 0.0, 0
        while not n or time.time() - start + last <= seconds:
            t0 = time.time()
            b = len(self.outs) % len(self.batches)
            with record_function("portbench.predict"):
                logits = self.predict({"image": self.batches[b]})
            self.ctx.sync()
            self.outs.append((b, logits))
            last = time.time() - t0
            n += 1
        return {"seconds": time.time() - start, "work": n * self.mix["batch_size"]}

    @property
    def attempted(self) -> int:
        return len(self.outs) * self.mix["batch_size"]

    def end_to_end(self, timed: Dict) -> Dict[str, float]:
        return {"eval_samples_per_s": timed["work"] / timed["seconds"],
                "peak_gib": self.ctx.window_peak / 2 ** 30}

    def counts(self) -> Dict:
        return {"flops_per_sample": counts.eva_clip_image_flops(self.cfg,
                                                                self.mix["num_classes"])}

    # -- correctness ---------------------------------------------------------
    def release(self) -> None:
        self.outputs = {"logits": self.outs}
        self.model = self.predict = None
        torch.cuda.empty_cache()

    def program_outputs(self) -> Dict:
        return self.outputs

    def sample_classes(self) -> torch.Tensor:
        k = self.mix["check"]["classes"]
        rng = np.random.default_rng([self.ctx.seed, 11])
        idx = np.sort(rng.choice(self.mix["num_classes"], size=k, replace=False))
        return torch.as_tensor(idx, device=self.ctx.device)

    @torch.no_grad()
    def reference_outputs(self, prec: Prec, **_) -> Dict:
        """Per distinct batch, the logits against the sampled classes."""
        P = self._weights(self.params)
        cls = self.sample_classes()
        emb = R.class_embeddings(P, self.cfg, prec, self.prompt_ids[cls])
        out = []
        for imgs in self.batches:
            x = torch.from_numpy(imgs).to(self.ctx.device)
            out.append(torch.cat([R.logits(P, self.cfg, prec, x[i:i + 32], emb)
                                  for i in range(0, x.shape[0], 32)]))
        return {"per_batch": out, "classes": cls}

    def as_program(self, ctrl: Dict, ref: Dict) -> Dict:
        """The control's logits in the program's place, one per distinct
        batch, at the sampled classes' columns."""
        out = []
        for b, lg in enumerate(ctrl["per_batch"]):
            full = torch.zeros((lg.shape[0], self.mix["num_classes"]), device=lg.device)
            full[:, ref["classes"]] = lg
            out.append((b, full))
        return {"logits": out}

    def judge(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        cls = ref["classes"]
        gaps = [float((lg[:, cls] - ref["per_batch"][b]).abs().max())
                for b, lg in prog["logits"]]
        scale = float(torch.cat(ref["per_batch"]).std())
        self.detail = {"gaps": gaps, "logit_gap_rel": max(gaps) / scale}
        return {"logit_gap": max(gaps)}
