"""Reading a ``torch.profiler`` trace of the window: the seconds in which
something ran on the card, the device operations that took most time, and
the longest idle gaps by what the host was doing.

The events are read from the profiler's raw results (``kineto_results``),
not through ``events()``, which builds a tree of every event and takes
minutes at a million of them.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GAP_MIN_S = 20e-6  # gaps shorter than a launch are not idle time worth naming


def _raw(prof):
    return prof.profiler.kineto_results.events()


def _kind(e) -> str:
    """The event's activity: kineto's own name where the event gives it
    (``activity_type``, newer torch), else from its device and name: on the
    card a memcpy, a memset, a span the host named (user annotation) or a
    kernel; on the host a runtime or driver call, or an op."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    user = getattr(e, "is_user_annotation", None)
    if "CUDA" in str(e.device_type()):
        if (user is not None and user()) or name.startswith(SPAN_PREFIX):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if (user is not None and user()) or name.startswith(SPAN_PREFIX):
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


def summarize(prof) -> Dict:
    """Over the span the harness names ``WINDOW``: {busy_s, window_s,
    kernels: {name: [count, seconds]}, device_ops: top 10 [name, seconds],
    idle_gaps: top 10 [host op, seconds]}."""
    events = _raw(prof)
    span = [e for e in events if e.name() == WINDOW and "CUDA" not in str(e.device_type())]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} spans named {WINDOW}")
    t0, t1 = span[0].start_ns(), span[0].end_ns()
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, List[float]] = {}
    host: List[Tuple[int, int, str]] = []
    for e in events:
        kind = _kind(e)
        s, t = e.start_ns(), e.end_ns()
        if t <= t0 or s >= t1:
            continue
        if kind in DEVICE_KINDS:
            s, t = max(s, t0), min(t, t1)
            dev.append((s, t))
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
        elif kind in HOST_KINDS and e.name() != WINDOW:
            host.append((s, t, e.name()))
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_t = None
    prev_end = t0
    for s, t in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            if s - prev_end > GAP_MIN_S * 1e9:
                gaps.append((prev_end, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        prev_end = max(prev_end, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    if t1 - prev_end > GAP_MIN_S * 1e9:
        gaps.append((prev_end, t1))
    idle = _label_gaps(gaps, host)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"busy_s": busy * 1e-9, "window_s": (t1 - t0) * 1e-9, "kernels": kernels,
            "device_ops": [[n[:200], v[1]] for n, v in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]}


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host op running at each gap's middle
    (the latest-starting one that spans it); "host, no op" where none does."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, t in gaps:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        label = "host, no op"
        # scan back over the ops that started before the middle; the first
        # one still running is the innermost (ops nest on the host thread)
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + (t - s) * 1e-9
    return out
