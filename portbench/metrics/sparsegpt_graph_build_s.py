"""sparsegpt_graph_build_s: the builds of SparseGPT's CUDA graphs of the
column sweep (a part of ``sparsegpt_sweep_s``), the sum over the pruned
stacks of the pruner's ``phase_times["fine_<stack>_graph_build_s"]`` (on
the card's clock), the mean over the untraced window's jobs."""


def read(run):
    stacks = [s for s, spec in run.mix.get("stack_specs", {}).items() if spec]
    vals = [sum(r["phase_times"][f"fine_{s}_graph_build_s"] for s in stacks)
            for r in run.timed.get("records", [])
            if all(f"fine_{s}_graph_build_s" in r["phase_times"] for s in stacks)]
    return sum(vals) / len(vals) if vals and stacks else None
