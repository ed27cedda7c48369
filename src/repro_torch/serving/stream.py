"""Sequential streaming driver + traffic scenarios.

``run_stream`` drives a ServingPipeline through per-window request
counts: it produces window t+1's chunk on the host while the device
still runs window t (kernel launches return before the device
finishes), and reads nothing back until the run ends.  Every window is a
pure function of (seed, t), so a rerun replays identical traffic.

Scenarios: ``constant`` (steady traffic) and ``spike`` (a burst over
three windows starting at the first third - the dual price lags the
burst and the guard absorbs it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

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
               clock=None, sync=None) -> StreamStats:
    """Serve ``sizes`` windows from ``source`` (anything with
    ``window(t, n) -> WindowChunk``), sequentially.

    ``clock`` (default ``time.perf_counter``) times host work.  Without
    ``sync`` the next
    window's chunk is produced while the device still runs this one and
    ``submit_ms`` is the launch time; with ``sync`` (e.g.
    ``torch.cuda.synchronize``) it is called after every window, so
    ``submit_ms`` and ``wall_s`` cover the device work too."""
    clock = clock or time.perf_counter
    t0 = clock()
    submit_ms: list[float] = []
    results: list[WindowResult] = []

    def prep(t: int, n: int):
        p0 = clock()
        chunk = source.window(t, n)
        return chunk, (clock() - p0) * 1e3

    nxt = prep(0, sizes[0]) if sizes else None
    for t, n in enumerate(sizes):
        chunk, prep_ms = nxt
        d0 = clock()
        res = pipeline.serve_window(chunk.ctx, chunk.rows,
                                    tables=chunk.tables)
        if sync is not None:
            sync()
        submit_ms.append((clock() - d0) * 1e3)
        res.prep_ms += prep_ms
        res.h2d_bytes += int(chunk.h2d_bytes)
        results.append(res)
        if t + 1 < len(sizes):  # prep t+1 while the device runs t
            nxt = prep(t + 1, sizes[t + 1])
    return StreamStats(windows=results, sizes=list(sizes),
                       submit_ms=submit_ms, wall_s=clock() - t0)


def window_table(stats: StreamStats) -> list[str]:
    """Per-window report lines: n, spend/budget, lambda, downgraded,
    revenue and host ms (prep + submit)."""
    lines = [f"{'win':>4} {'n':>5} {'spend/budget':>13} {'lam':>11} "
             f"{'downgraded':>10} {'revenue':>9} {'ms':>9}"]
    for t, r in enumerate(stats.windows):
        lines.append(
            f"{t:>4} {r.n_valid:>5} {float(r.spend) / r.budget:>13.4f} "
            f"{float(r.lam_after):>11.4e} {int(r.downgraded):>10d} "
            f"{float(np.sum(r.revenue_np)):>9.1f} "
            f"{r.prep_ms + stats.submit_ms[t]:>9.2f}")
    return lines
