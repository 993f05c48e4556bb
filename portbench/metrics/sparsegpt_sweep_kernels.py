"""sparsegpt_sweep_kernels: the launches of SparseGPT's sweep kernel a job
(one a column block of each weight group), the sum over the pruned stacks
of the pruner's ``phase_times["fine_<stack>_sweep_kernels_n"]``, the mean
over the untraced window's jobs. None where the program counts no such
launch."""


def read(run):
    stacks = [s for s, spec in run.mix.get("stack_specs", {}).items() if spec]
    vals = [sum(r["phase_times"][f"fine_{s}_sweep_kernels_n"] for s in stacks)
            for r in run.timed.get("records", [])
            if all(f"fine_{s}_sweep_kernels_n" in r["phase_times"] for s in stacks)]
    return sum(vals) / len(vals) if vals and stacks else None
