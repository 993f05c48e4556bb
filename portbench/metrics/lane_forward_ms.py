"""lane_forward_ms: the lane ensemble's mean forward, in ms: the seconds
of every ``SuffixPlan.lane_losses`` call (the pruner's ``phase_times
["coarse_<stack>_lanes_s"]``, on the card's clock) over their count
(``coarse_<stack>_lanes_n``), over the untraced window's jobs."""


def _total(phase_times, suffix):
    return sum(v for k, v in phase_times.items()
               if k.startswith("coarse_") and k.endswith(suffix))


def read(run):
    pts = [r["phase_times"] for r in run.timed.get("records", [])]
    n = sum(_total(pt, "_lanes_n") for pt in pts)
    return 1000.0 * sum(_total(pt, "_lanes_s") for pt in pts) / n if n else None
