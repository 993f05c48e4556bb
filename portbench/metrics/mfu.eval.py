"""mfu.eval: the operations one image needs (``counts.py``) times the
images a second of the untraced window, as a share of the card's bf16
peak."""

from portbench.counts import BF16_FLOPS


def read(run):
    flops = run.counts.get("flops_per_sample")
    if not flops or not run.timed["work"]:
        return None
    return 100.0 * flops * run.timed["work"] / run.timed["seconds"] / BF16_FLOPS
