"""Fixed-shape programs over static buffers, captured as CUDA graphs.

The port's counterpart of ``jax.jit`` at a fixed shape.  A ``Program``
wraps a function of no arguments that reads static input buffers and
returns a dict of output tensors.  With ``capture`` (on the card) its
first call runs the function eagerly on the program's side stream - the
warm-up a capture needs, whose result is that call's result - and then
captures the function as a CUDA graph; every later call replays the
graph on the caller's stream and returns the graph's static outputs,
the same tensors every time.  Without ``capture`` every call runs the
function eagerly and copies its result into the same static outputs, so
the buffers alias alike either way: a caller that keeps a result past
the next call copies it.

A capture launches nothing, so it starts its static outputs at zero and
keeps the kernel wrappers' counts apart (``ops.recording``); each replay
adds them to ``ops.LAUNCHES``.  Captures use ``thread_local`` error mode,
so another thread's CUDA calls (a producer thread filling the next
chunk) cannot invalidate them, and run with Python's cyclic garbage
collector off, so no graph freed meanwhile can.  A capture that fails
raises; nothing falls back to eager.

The stream helpers below are no-ops on the CPU (``stream=None``).
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.kernels import ops


def side_stream(device: torch.device):
    """A new CUDA stream on ``device``, or None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def record_event(stream):
    """An event recorded on ``stream`` now (None without a stream)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def consume(tensors, ready) -> None:
    """Before the current stream reads ``tensors`` that another stream
    produced: wait on the device for ``ready`` (the producer's event) and
    mark them used on this stream, so their memory is not handed out
    again before this stream is done with them."""
    if ready is None:
        return
    cur = torch.cuda.current_stream()
    cur.wait_event(ready)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(cur)


class Program:
    """``fn()`` over static buffers: a CUDA graph on the card, eager
    elsewhere (see the module docstring).  ``pool`` shares one graph
    memory pool between programs replayed in the order they were
    captured.  ``builds`` counts captures (first eager runs without
    capture); ``capture_ms`` and ``pool_bytes`` measure the capture: its
    wall time (recording and instantiation) and the device memory
    reserved meanwhile, which is its graph pool's unless another thread
    allocated at the same time."""

    def __init__(self, fn, *, capture: bool, stream=None, pool=None):
        if capture and stream is None:
            raise ValueError("a captured program needs a side stream")
        self.fn = fn
        self.capture = capture
        self.stream = stream
        self.pool = pool
        self.graph = None
        self.out: dict | None = None
        self.builds = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._launches: dict = {}

    @torch.no_grad()
    def __call__(self) -> dict:
        if self.graph is not None:
            self.graph.replay()
            ops.add_launches(self._launches)
            return self.out
        if self.capture:
            return self._capture()
        out = self.fn()
        if self.out is None:
            self.out = out
            self.builds += 1
        else:
            for k, v in out.items():
                self.out[k].copy_(v)
        return self.out

    def _capture(self) -> dict:
        cur = torch.cuda.current_stream()
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()  # the warm-up, and this call's result
        cur.wait_stream(side)
        for v in out.values():
            v.record_stream(cur)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # so the reserved delta is the pool
        r0 = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector stays off while capturing: a graph it
        # frees there (programs' closures form cycles) would invalidate
        # this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # entering collects and synchronises: the timer starts after
            with ops.recording() as launches, torch.cuda.graph(
                    graph, pool=self.pool, stream=side,
                    capture_error_mode="thread_local"):
                t0 = time.perf_counter()
                static = self.fn()
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved() - r0
        with torch.cuda.stream(side):
            for v in static.values():
                v.zero_()
        cur.wait_stream(side)
        self.graph, self.out, self._launches = graph, static, launches
        self.builds += 1
        return out
