"""perturb_roofline: kernel 2 (the out-of-place perturbation of
``csrc/perturb.cu``) against its bound: the least time its launches in the
traced window could take (``counts.py``: bytes over HBM bandwidth) over
the device time the trace gives them. Nothing is read unless the trace
holds exactly the launches the traced window's jobs make."""

KERNEL = "perturb_kernel"


def read(run):
    p = run.counts.get("perturb")
    if not p or run.trace is None:
        return None
    hits = [v for n, v in run.trace["kernels"].items() if KERNEL in n]
    count, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    jobs = run.traced["work"] if run.traced else 0
    if not jobs or count != p["launches"] * jobs or secs <= 0:
        return None
    return 100.0 * p["bound_s"] * jobs / secs
