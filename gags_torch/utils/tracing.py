"""Spans on the profiler's clock: which part of a step or a request the
time goes to, recorded while a torch.profiler session runs.

`span(name, device=None)` marks a region of code. It records only while
a torch.profiler session is running in the process, as the global flag
`torch.autograd.profiler._is_profiler_enabled` says: every thread sees
that flag, whereas the profiler itself records the CPU ops and ranges of
the thread that started it alone. Off, `span` returns one shared no-op
context: no profiler range, no allocation, no CUDA call.

On, a span records its name, its start and end, its thread (the native
id the Chrome trace shows), the span it was opened under and the id of
its root span, which every span of one step or request shares. Start and
end are Unix nanoseconds (`time.time_ns()`), the clock of the profiler's
events: an event's start in microseconds plus the profile's
`trace_start_ns()`. So a span of any thread lies over the device trace.
On the thread the profiler records, the span also opens a profiler
range of its name, which puts it in the Chrome trace; on other threads
that range would record nothing and is skipped. The range is a function
range (`torch._C._profiler._RecordFunctionFast`), not
`torch.profiler.record_function`: a user annotation of the latter makes
the profiler add a device-side record spanning the kernels launched
under it, which a reader of the trace would count as device work.

With `device` a CUDA device the span records two timing CUDA events on
that device's current stream: its `device_ms` is the stream's elapsed
time between them, the region's kernels and any gap in which the device
waited for the host. The events come from a free list: a pair goes back
to it once its end event has completed and its time has been read, so a
window creates events only until the list covers how far the host runs
ahead of the device, and a later window none. The region is never
synchronised.

Spans live in memory, up to `CAPACITY`; a span opened when the buffer is
full is counted as dropped and records nothing. A span decides at entry
whether it records. `snapshot()` returns the records in the order they
ended, each with `device_ms` (None without events), and the number
dropped; `clear()` empties the buffer.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 200_000


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_records: list = []
_unread: collections.deque = collections.deque()  # device spans ended, events not read
_free: dict = {}  # device index -> [(start event, end event), ...] ready for reuse
_taken = 0  # spans admitted since the last clear(), ended or not
_dropped = 0


def _read_events(s: "Span") -> None:
    """`s.device_ms` from its events, and the pair back to the free list."""
    start, end = s._events
    s.device_ms = start.elapsed_time(end)
    _free.setdefault(s._stream.device_index, []).append(s._events)
    s._events = None


def _read_all() -> None:
    """Wait for every unread device span's end event and read it."""
    while _unread:
        s = _unread.popleft()
        s._events[1].synchronize()
        _read_events(s)


def _event_pair(stream):
    """A free pair of timing events for `stream`'s device, reading the
    spans whose end event has completed first; a new pair if none has."""
    free = _free.setdefault(stream.device_index, [])
    if not free:
        while _unread and _unread[0]._events[1].query():
            _read_events(_unread.popleft())
    if free:
        return free.pop()
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class Span:
    """One recording span; made by `span` when the profiler runs."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "device_ms",
                 "_rf", "_stream", "_events")

    def __init__(self, name: str, sid: int, stream, events):
        self.name, self.id, self.device_ms = name, sid, None
        self._stream, self._events = stream, events

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        self.thread = threading.get_native_id()
        stack.append(self)
        self._rf = None
        if torch._C._autograd._profiler_enabled():  # this thread is recorded
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        if self._events is not None:
            self._events[0].record(self._stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            _records.append(self)
            if self._events is not None:
                _unread.append(self)
        return False


def span(name: str, device=None):
    """A context that records `name` while a profiler session runs (see
    the module's docstring); `device`: a CUDA torch.device whose current
    stream the span also times with events, or None."""
    global _taken, _dropped
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    stream = None
    if device is not None and device.type == "cuda":
        stream = torch.cuda.current_stream(device)
    with _lock:
        if _taken >= CAPACITY:
            _dropped += 1
            return _NOOP
        _taken += 1
        sid = next(_ids)
        events = _event_pair(stream) if stream is not None else None
    return Span(name, sid, stream, events)


def snapshot() -> dict:
    """{"spans": [record, ...] in the order they ended, "dropped": n}; a
    record is a dict of name, id, parent, root, thread, start_ns, end_ns
    and device_ms. Waits for the device spans' end events."""
    with _lock:
        _read_all()
        out = [dict(name=s.name, id=s.id, parent=s.parent, root=s.root, thread=s.thread,
                    start_ns=s.start_ns, end_ns=s.end_ns, device_ms=s.device_ms)
               for s in _records]
        return dict(spans=out, dropped=_dropped)


def clear() -> None:
    """Forget every record and the dropped count; the events of spans not
    yet read are read first, so their pairs go back to the free list."""
    global _taken, _dropped
    with _lock:
        _read_all()
        _records.clear()
        _taken = _dropped = 0
