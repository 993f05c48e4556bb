"""fine_collect_s: the fine stage's statistics passes, the sum over the
pruned stacks of the pruner's ``phase_times["fine_<stack>_collect_s"]``
(on the card's clock), the mean over the untraced window's jobs."""


def read(run):
    stacks = [s for s, spec in run.mix.get("stack_specs", {}).items() if spec]
    vals = [sum(r["phase_times"][f"fine_{s}_collect_s"] for s in stacks)
            for r in run.timed.get("records", [])
            if all(f"fine_{s}_collect_s" in r["phase_times"] for s in stacks)]
    return sum(vals) / len(vals) if vals and stacks else None
