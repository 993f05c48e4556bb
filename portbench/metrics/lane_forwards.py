"""lane_forwards: the lane ensemble's forwards a job (``SuffixPlan
.lane_losses`` calls), the sum over the stacks of the pruner's
``phase_times["coarse_<stack>_lanes_n"]``, the mean over the untraced
window's jobs."""


def read(run):
    vals = [sum(v for k, v in r["phase_times"].items()
                if k.startswith("coarse_") and k.endswith("_lanes_n"))
            for r in run.timed.get("records", [])
            if any(k.startswith("coarse_") and k.endswith("_lanes_n") for k in r["phase_times"])]
    return sum(vals) / len(vals) if vals else None
