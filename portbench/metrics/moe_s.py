"""moe_s: the seconds of a sparse-expert model's expert layers (the
program's span ``ecoflap.model.moe``, each layer's router, dispatch,
experts and combine, forwards only, in both stages; the pruner's
``phase_times["moe_s"]``, on the card's clock), the mean over the untraced
window's jobs. None where the program records no such span."""


def read(run):
    vals = [r["phase_times"]["moe_s"] for r in run.timed.get("records", [])
            if "moe_s" in r["phase_times"]]
    return sum(vals) / len(vals) if vals else None
