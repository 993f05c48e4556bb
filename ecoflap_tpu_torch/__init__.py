"""ecoflap_tpu_torch — the PyTorch/CUDA port of the ECoFLaP coarse-to-fine
pruning pipeline, for one NVIDIA H100.

It computes what the JAX package ``ecoflap_tpu`` computes and keeps its
layout, so each module has a counterpart of the same name there:

  core/      prune-spec parsing, the registry, device selection
  data/      tokenizers, calibration batches, the evaluation image
             transform and annotation datasets
  models/    BLIP-2 FlanT5 and LLaMA as ``nn.Module``s under the
             reference's state-dict names, generation (greedy and beam
             search over a KV cache), plus the JAX-params loader
  ops/       hand-written Hopper kernels (``csrc/``) with their plain
             PyTorch versions
  pruning/   the coarse stages (zeroth- and first-order), the Wanda and
             SparseGPT fine stages, the global baselines
  tasks/     VQA, GQA, captioning and language-model scorers
  runners/   the evaluation loop, sparsity-dict and statistics writers
  cli/       the prune and evaluate entry points

Nothing here imports ``jax`` or ``ecoflap_tpu``.
"""

__version__ = "0.1.0"
