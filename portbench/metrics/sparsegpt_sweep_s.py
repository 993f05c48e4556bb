"""sparsegpt_sweep_s: SparseGPT's column sweeps, the sum over the pruned
stacks of ``phase_times["fine_<stack>_sweep_s"]``, the mean over the
untraced window's jobs."""


def read(run):
    stacks = [s for s, spec in run.mix.get("stack_specs", {}).items() if spec]
    vals = [sum(r["phase_times"][f"fine_{s}_sweep_s"] for s in stacks)
            for r in run.timed.get("records", [])
            if all(f"fine_{s}_sweep_s" in r["phase_times"] for s in stacks)]
    return sum(vals) / len(vals) if vals and stacks else None
