"""mfu.prune: the operations one prune job needs (``counts.py``) times the
untraced window's jobs over its seconds, as a share of the card's bf16
peak."""

from portbench.counts import BF16_FLOPS


def read(run):
    flops = run.counts.get("flops_per_job")
    if not flops or not run.timed["work"]:
        return None
    return 100.0 * flops["total"] * run.timed["work"] / run.timed["seconds"] / BF16_FLOPS
