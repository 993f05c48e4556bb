"""coarse_s: the coarse stage's seconds (the pruner's ``phase_times
["coarse_s"]``, taken after a device synchronise), the mean over the
untraced window's jobs."""


def read(run):
    vals = [r["phase_times"]["coarse_s"] for r in run.timed.get("records", [])
            if "coarse_s" in r["phase_times"]]
    return sum(vals) / len(vals) if vals else None
