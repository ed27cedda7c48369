"""Streaming driver + traffic scenarios.

``run_stream`` drives a ServingPipeline through per-window request
counts.  With ``prefetch`` > 0 one producer thread makes the chunks in
window order into a bounded queue, on a CUDA stream of its own, while
the serving thread serves: host hashing and scoring launches overlap
the device's work on earlier windows, and the serving thread blocks
only on a chunk not ready yet (``stall_ms``).  ``prefetch=0`` is the
sequential double-buffered reference: window t+1's chunk is produced
while the device still runs window t.  Every window is a pure function
of (seed, t), so both are bitwise identical and a rerun replays
identical traffic.

Scenarios: ``constant`` (steady traffic) and ``spike`` (a burst over
three windows starting at the first third - the dual price lags the
burst and the guard absorbs it).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graphs import side_stream
from repro_torch.serving.pipeline import ServingPipeline, WindowResult


@dataclass(frozen=True)
class TrafficScenario:
    """A named per-window traffic shape (see ``SCENARIOS``)."""

    name: str
    n_windows: int
    n_base: int
    spike_mult: float = 3.0

    def window_sizes(self) -> list[int]:
        return scenario_windows(self)


def _constant_windows(sc: TrafficScenario) -> list[int]:
    """``n_base`` requests every window (steady state)."""
    return [sc.n_base] * sc.n_windows


def _spike_windows(sc: TrafficScenario) -> list[int]:
    """``n_base`` with a ``spike_mult`` x burst over the 3 windows
    starting at the first third (paper Fig. 5 protocol)."""
    sizes = []
    for t in range(sc.n_windows):
        burst = sc.n_windows // 3 <= t < sc.n_windows // 3 + 3
        sizes.append(int(sc.n_base * (sc.spike_mult if burst else 1.0)))
    return sizes


SCENARIOS: dict = {
    "constant": _constant_windows,
    "spike": _spike_windows,
}


def scenario_windows(sc: TrafficScenario) -> list[int]:
    """Per-window request counts for a scenario."""
    try:
        builder = SCENARIOS[sc.name]
    except KeyError:
        raise ValueError(f"unknown scenario {sc.name!r}: valid "
                         f"scenarios are {', '.join(SCENARIOS)}") from None
    return [max(1, n) for n in builder(sc)]


@dataclass
class StreamStats:
    """Host-side view of a finished streaming run."""

    windows: list[WindowResult]
    sizes: list[int]
    submit_ms: list[float]  # host time per serve_window call
    wall_s: float

    @property
    def prep_ms(self) -> list[float]:
        return [float(r.prep_ms) for r in self.windows]

    @property
    def stall_ms(self) -> list[float]:
        return [float(r.stall_ms) for r in self.windows]

    @property
    def dispatch_ms(self) -> list[float]:
        """Per-window prep + submit."""
        return [p + s for p, s in zip(self.prep_ms, self.submit_ms)]

    @property
    def h2d_bytes(self) -> int:
        """Host->device bytes across the run (chunk production and the
        windows' own uploads)."""
        return int(sum(int(r.h2d_bytes) for r in self.windows))

    @property
    def compiles(self) -> list[int]:
        """Per-window program captures (``WindowResult.compiles``)."""
        return [int(r.compiles) for r in self.windows]

    @property
    def steady_compiles(self) -> int:
        """Captures in windows whose padding bucket was already served
        earlier in the run: bucketed padding keeps this at zero however
        traffic swings, every shape capturing once, on first sight."""
        seen: set = set()
        steady = 0
        for r in self.windows:
            if r.bucket in seen:
                steady += int(r.compiles)
            seen.add(r.bucket)
        return steady

    @property
    def total_revenue(self) -> float:
        return float(sum(r.revenue_np.sum() for r in self.windows))

    def overshoot(self, c_min: float) -> float:
        """Max relative spend overshoot vs. max(budget, n*c_min)."""
        worst = 0.0
        for r in self.windows:
            cap = max(r.budget, r.n_valid * c_min)
            worst = max(worst, float(r.spend) / cap - 1.0)
        return worst


def run_stream(pipeline: ServingPipeline, sizes: list[int], source, *,
               lam_trace=None, prefetch: int = 2, clock=None,
               sync=None) -> StreamStats:
    """Serve ``sizes`` windows from ``source`` (anything with
    ``window(t, n) -> WindowChunk``).

    ``prefetch`` > 0: one producer thread, running on its own CUDA
    stream, makes the chunks strictly in window order into a queue of
    depth ``prefetch``; its exception is raised in the serving thread.
    A chunk's tables reach the serving stream through its ``ready``
    event.  ``prefetch=0``: the sequential double-buffered path.
    ``lam_trace`` pins each window's entry price (parity checks).
    ``clock`` (default ``time.perf_counter``) times host work: per
    window ``prep_ms`` (chunk production), ``stall_ms`` (the serving
    thread's wait for it) and ``submit_ms`` (``serve_window``).  Without
    ``sync`` the serving thread goes on while the device still runs;
    with ``sync`` (e.g. ``torch.cuda.synchronize``) it is called after
    every window, so ``submit_ms`` and ``wall_s`` cover the device work
    too."""
    clock = clock or time.perf_counter
    submit_ms: list[float] = []
    results: list[WindowResult] = []

    def prep(t: int, n: int):
        p0 = clock()
        chunk = source.window(t, n)
        return chunk, (clock() - p0) * 1e3

    def serve(t: int, item, stall: float) -> None:
        chunk, prep_ms = item
        d0 = clock()
        res = pipeline.serve_window(
            chunk.ctx, chunk.rows, tables=chunk.tables,
            lam=None if lam_trace is None else lam_trace[t],
            ready=getattr(chunk, "ready", None))
        if sync is not None:
            sync()
        submit_ms.append((clock() - d0) * 1e3)
        res.prep_ms += prep_ms
        res.stall_ms += stall
        res.h2d_bytes += int(chunk.h2d_bytes)
        results.append(res)

    t0 = clock()
    if prefetch > 0:
        q: queue.Queue = queue.Queue(maxsize=int(prefetch))
        stream = side_stream(pipeline.device)

        def produce():
            try:
                with torch.cuda.stream(stream):
                    for t, n in enumerate(sizes):
                        q.put(prep(t, n))
            except BaseException as e:  # surface in the serving thread
                q.put(e)

        th = threading.Thread(target=produce, daemon=True,
                              name="chunk-prefetch")
        th.start()
        try:
            for t in range(len(sizes)):
                s0 = clock()
                item = q.get()
                stall = (clock() - s0) * 1e3
                if isinstance(item, BaseException):
                    raise item
                serve(t, item, stall)
        finally:
            while th.is_alive():  # unblock a producer stuck on q.put
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=0.05)
    else:
        nxt = prep(0, sizes[0]) if sizes else None
        for t in range(len(sizes)):
            serve(t, nxt, 0.0)
            if t + 1 < len(sizes):  # prep t+1 while the device runs t
                nxt = prep(t + 1, sizes[t + 1])
    return StreamStats(windows=results, sizes=list(sizes),
                       submit_ms=submit_ms, wall_s=clock() - t0)


def window_table(stats: StreamStats) -> list[str]:
    """Per-window report lines: n, spend/budget, lambda, downgraded,
    revenue, host ms (prep + submit), stall ms, captures and bucket."""
    lines = [f"{'win':>4} {'n':>5} {'spend/budget':>13} {'lam':>11} "
             f"{'downgraded':>10} {'revenue':>9} {'ms':>9} {'stall':>8} "
             f"{'cap':>3} bucket"]
    for t, r in enumerate(stats.windows):
        lines.append(
            f"{t:>4} {r.n_valid:>5} {float(r.spend) / r.budget:>13.4f} "
            f"{float(r.lam_after):>11.4e} {int(r.downgraded):>10d} "
            f"{float(np.sum(r.revenue_np)):>9.1f} "
            f"{r.prep_ms + stats.submit_ms[t]:>9.2f} {r.stall_ms:>8.2f} "
            f"{r.compiles:>3d} {r.bucket}")
    return lines
