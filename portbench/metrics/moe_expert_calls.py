"""moe_expert_calls: the expert evaluations a job, each layer call's
experts that received at least one token (the program's counter
``ecoflap.model.moe.expert_calls``, the pruner's
``phase_times["moe_expert_calls_n"]``), the mean over the untraced window's
jobs. None where the program counts no such call."""


def read(run):
    vals = [r["phase_times"]["moe_expert_calls_n"] for r in run.timed.get("records", [])
            if "moe_expert_calls_n" in r["phase_times"]]
    return sum(vals) / len(vals) if vals else None
