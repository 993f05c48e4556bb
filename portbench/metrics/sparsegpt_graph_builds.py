"""sparsegpt_graph_builds: the CUDA graphs of SparseGPT's column sweep
built a job, the sum over the pruned stacks of the pruner's
``phase_times["fine_<stack>_graph_builds_n"]``, the mean over the untraced
window's jobs."""


def read(run):
    stacks = [s for s, spec in run.mix.get("stack_specs", {}).items() if spec]
    vals = [sum(r["phase_times"][f"fine_{s}_graph_builds_n"] for s in stacks)
            for r in run.timed.get("records", [])
            if all(f"fine_{s}_graph_builds_n" in r["phase_times"] for s in stacks)]
    return sum(vals) / len(vals) if vals and stacks else None
