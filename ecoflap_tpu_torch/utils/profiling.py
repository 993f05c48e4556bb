"""Spans, counters and traces of the port's phases.

* ``span(name, **tags)``: a context manager that times what runs inside
  it. Its tags (the stack, say) are its own and those of the span it opens
  in, its parent: the innermost open span.
* ``count(name, n=1, **tags)``: adds ``n`` to a counter, tagged as a span.
* ``recording(device)``: collects the spans and counts made inside it,
  for one prune. On a CUDA device a span records two
  ``torch.cuda.Event(enable_timing=True)`` on the current stream (from a
  pool the recordings share) and nothing else: no synchronise, no
  ``.item()``, no copy to the host. On the CPU it reads
  ``time.perf_counter``. The
  recording resolves its spans once, when it closes: one synchronise of
  the device, then totals by name and tags, in seconds on the device's
  clock (``seconds``; ``self_seconds`` less the children's) and counts
  (``counts``).
* ``trace(log_dir)``: a ``torch.profiler`` run over a block, its Chrome
  trace written to ``log_dir/<name>.json``. While any profiler runs, each
  span also enters ``torch.profiler.record_function(name)``, so its name
  lies in the trace's timeline beside the kernels and copies.

Outside any recording and any profiler, ``span`` returns a shared no-op
after reading two flags, and ``count`` returns after reading one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from ecoflap_tpu_torch.core.device import synchronize

Key = Tuple[str, Tuple[Tuple[str, Any], ...]]  # (name, sorted tags)

# the open recordings, innermost last: spans and counts go to the last
_open: List["Recording"] = []
# timing events for reuse, per CUDA device index
_event_pool: Dict[int, List[torch.cuda.Event]] = {}


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("rec", "name", "tags", "parent", "start", "end", "prof", "secs",
                 "child_secs")

    def __init__(self, rec: Optional["Recording"], name: str, tags: Dict[str, Any]):
        self.rec, self.name, self.tags = rec, name, tags
        self.parent = self.start = self.end = self.prof = None
        self.secs = self.child_secs = 0.0

    def __enter__(self) -> "_Span":
        if _profiler_on():
            self.prof = _autograd_profiler.record_function(self.name)
            self.prof.__enter__()
        if self.rec is not None:
            self.rec._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self.rec is not None:
            self.rec._exit(self)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, **tags: Any):
    """A context manager timing its block under ``name`` in the open
    recording, and naming it in a running profiler's trace."""
    if not _open and not _profiler_on():
        return _NO_SPAN
    return _Span(_open[-1] if _open else None, name, tags)


def count(name: str, n: int = 1, **tags: Any) -> None:
    """Add ``n`` to the open recording's counter ``name``; nothing when no
    recording is open."""
    if _open:
        _open[-1]._count(name, n, tags)


class Recording:
    """The spans and counts of one ``recording``; ``seconds``,
    ``self_seconds`` and ``counts`` ({(name, tags): total}, in the order
    each key first opened) are filled when it closes."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self._pool = (_event_pool.setdefault(
            torch.cuda.current_device() if device.index is None else device.index, [])
            if self.cuda else [])
        self._stack: List[_Span] = []
        self._spans: List[_Span] = []
        self.seconds: Dict[Key, float] = {}
        self.self_seconds: Dict[Key, float] = {}
        self.counts: Dict[Key, int] = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _enter(self, s: _Span) -> None:
        s.parent = self._stack[-1] if self._stack else None
        if s.parent is not None and s.parent.tags:
            s.tags = {**s.parent.tags, **s.tags}
        s.start = self._mark()
        self._stack.append(s)
        self._spans.append(s)

    def _exit(self, s: _Span) -> None:
        self._stack.pop()
        s.end = self._mark()

    def _count(self, name: str, n: int, tags: Dict[str, Any]) -> None:
        if self._stack and self._stack[-1].tags:
            tags = {**self._stack[-1].tags, **tags}
        key = (name, tuple(sorted(tags.items())))
        self.counts[key] = self.counts.get(key, 0) + n

    def _resolve(self) -> None:
        synchronize(self.device)
        done = [s for s in self._spans if s.start is not None and s.end is not None]
        for s in done:
            s.secs = (s.start.elapsed_time(s.end) * 1e-3 if self.cuda
                      else s.end - s.start)
            if s.parent is not None:
                s.parent.child_secs += s.secs
        for s in done:
            key = (s.name, tuple(sorted(s.tags.items())))
            self.seconds[key] = self.seconds.get(key, 0.0) + s.secs
            self.self_seconds[key] = (self.self_seconds.get(key, 0.0)
                                      + s.secs - s.child_secs)

    def _release(self) -> None:
        if self.cuda:
            self._pool.extend(e for s in self._spans for e in (s.start, s.end)
                              if e is not None)
        self._spans = []


@contextlib.contextmanager
def recording(device: torch.device) -> Iterator[Recording]:
    """Record the spans and counts made inside the block, on ``device``'s
    clock; the totals are read once the block has ended."""
    rec = Recording(device)
    _open.append(rec)
    try:
        yield rec
        _open.pop()
        rec._resolve()
    finally:
        if _open and _open[-1] is rec:
            _open.pop()
        rec._release()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "ecoflap"):
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activity, its Chrome trace written to ``log_dir/<name>.json``; a no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with record_function(name):
            yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
