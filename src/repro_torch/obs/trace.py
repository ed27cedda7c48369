"""Span tracing with a Chrome-trace-event (Perfetto) exporter.

``Tracer.span("prep")`` wraps a host-side phase of the serving loop in
a context manager that records one complete ("ph": "X") event: name,
thread id, start timestamp and duration in microseconds.  Spans are
recorded from ANY thread - the streaming driver's prefetch worker and
serving thread land on separate tracks, which is what makes the
overlap/stall story visible in a trace viewer - and recording is a
single ``list.append`` (atomic under the GIL), so the prefetch queue is
never blocked by telemetry.

``chrome_trace()``/``write()`` export the standard Chrome trace-event
JSON object format: load the file in Perfetto (https://ui.perfetto.dev)
or chrome://tracing and every run opens as one timeline, threads named
via ``thread_name`` metadata events.

``Tracer(annotate=True)`` additionally opens a
``torch.profiler.record_function`` range for every span, so when the
driver also runs ``torch.profiler.profile`` (``launch/serve.py
--profile-dir``) the host spans line up against the card's kernels in
the same profile.  Spans are host-side only: none is opened inside a
captured CUDA graph.

A disabled tracer (``Tracer(enabled=False)``, or the shared
``NULL_TRACER``) hands back ONE stateless no-op context manager:
``span`` costs a method call, allocates nothing, takes no locks.
"""
from __future__ import annotations

import json
import os
import threading
import time

from torch.profiler import record_function


class _NullSpan:
    """Shared no-op span of a disabled tracer (stateless, reentrant)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "annotation")

    def __init__(self, tracer, name, args):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.annotation = None

    def __enter__(self):
        if self.tracer.annotate:
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.t0 = self.tracer.clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = self.tracer.clock_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        th = threading.current_thread()
        # one append; CPython list.append is atomic, no lock needed
        self.tracer.events.append(
            (self.name, th.ident, th.name, self.t0, t1 - self.t0,
             self.args))
        return False


class Tracer:
    """Collects host spans; exports Chrome trace-event JSON."""

    def __init__(self, enabled: bool = True, *, annotate: bool = False,
                 process_label: str | None = None,
                 clock_ns=time.perf_counter_ns):
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self.process_label = process_label
        self.clock_ns = clock_ns
        self.events: list = []

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event on the calling thread."""
        if not self.enabled:
            return
        th = threading.current_thread()
        self.events.append((name, th.ident, th.name, self.clock_ns(), 0,
                            args or None))

    # -- export ----------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object: ``traceEvents`` complete
        ("X") events in microseconds plus ``thread_name`` metadata so
        Perfetto labels the serving and prefetch tracks."""
        pid = os.getpid()
        events = list(self.events)  # snapshot (other threads may append)
        out = []
        tids: dict[int, str] = {}
        for name, tid, tname, t0_ns, dur_ns, args in events:
            tids.setdefault(tid, tname)
            ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
                  "ts": t0_ns / 1e3, "dur": dur_ns / 1e3, "cat": "host"}
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            out.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(tids.items())]
        if self.process_label:  # one named track group per host
            meta.insert(0, {"name": "process_name", "ph": "M",
                            "pid": pid,
                            "args": {"name": self.process_label}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the trace JSON; open the file in ui.perfetto.dev."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def merge_chrome_traces(paths, out_path: str | None = None) -> dict:
    """Merge per-host trace files into ONE Chrome trace-event object.

    Each host of a multi-host run writes its own trace
    (``Tracer(process_label=...).write``); pids are distinct processes,
    so concatenating the event lists yields one timeline in which every
    host appears as its own named track group (the ``process_name``
    metadata events survive the merge).  Timestamps are
    ``perf_counter_ns``-based and therefore NOT cross-host aligned -
    the merged view answers "what did each host do", not "who was
    first by a microsecond".
    """
    events: list = []
    for p in paths:
        with open(p) as f:
            events.extend(json.load(f).get("traceEvents", []))
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path is not None:
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


NULL_TRACER = Tracer(enabled=False)
