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

Scenarios live in the ``SCENARIOS`` registry, the one source of valid
names (``launch/serve.py``'s ``--scenario`` choices derive from it):
one function a name, mapping a scenario to its per-window request counts.
``run_stream`` can thread per-window budget and cost-scale traces into
the pipeline, which is how a serving loop prices each window of a carbon or
geo day at its grid intensity.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graphs import side_stream
from repro_torch.obs import MS_EDGES, get_obs, log2_edges
from repro_torch.serving.pipeline import ServingPipeline, WindowResult


@dataclass(frozen=True)
class TrafficScenario:
    """A named per-window traffic shape (see ``SCENARIOS``)."""

    name: str
    n_windows: int
    n_base: int
    spike_mult: float = 3.0
    n_tenants: int = 1

    def window_sizes(self) -> list[int]:
        return scenario_windows(self)


def _constant_windows(sc: TrafficScenario) -> list[int]:
    """``n_base`` requests every window (steady state)."""
    return [sc.n_base] * sc.n_windows


def _spike_windows(sc: TrafficScenario) -> list[int]:
    """``n_base`` with a ``spike_mult`` x burst over the 3 windows
    starting at the first third (paper Fig. 5 protocol: the price lags
    the burst, the guard absorbs it)."""
    sizes = []
    for t in range(sc.n_windows):
        burst = sc.n_windows // 3 <= t < sc.n_windows // 3 + 3
        sizes.append(int(sc.n_base * (sc.spike_mult if burst else 1.0)))
    return sizes


def _diurnal_windows(sc: TrafficScenario) -> list[int]:
    """One day-curve sinusoid over ``n_windows``, swinging between
    ~0.4x and ~1.6x of ``n_base``."""
    sizes = []
    for t in range(sc.n_windows):
        phase = 2.0 * math.pi * t / max(1, sc.n_windows)
        sizes.append(int(sc.n_base * (1.0 + 0.6 * math.sin(phase))))
    return sizes


def _tenants_windows(sc: TrafficScenario) -> list[int]:
    """Constant traffic in ``n_tenants`` equal blocks a window (spec
    ``[TenantAxis(budgets, priced=...)]``: per-tenant budgets under one
    shared price, per-tenant prices, or independent pipelines - see
    ``launch/serve.py --tenant-mode``)."""
    return _constant_windows(sc)


def _carbon_windows(sc: TrafficScenario) -> list[int]:
    """The diurnal day-curve, priced at kappa*CI(t) and budgeted in
    gCO2e a window (spec ``[GlobalAxis(pricing="carbon")]``); the carbon
    part lives in the (budget, cost_scale) traces fed to ``run_stream``."""
    return _diurnal_windows(sc)


def _georegions_windows(sc: TrafficScenario) -> list[int]:
    """The day-curve served by the two-region router (spec
    ``[RegionAxis(2), GlobalAxis(pricing="carbon")]``): (R,) gram budgets
    and (R,) kappa*CI_r(t) scales a window."""
    return _diurnal_windows(sc)


def _geotenants_windows(sc: TrafficScenario) -> list[int]:
    """The day-curve with both axes (spec ``[TenantAxis(budgets,
    priced=True), RegionAxis(2), GlobalAxis(pricing="carbon")]``):
    tenant gram budgets and region gram caps priced together, a tenant-t
    request paying (lam_tenant[t] + lam_region[r]) * c_{j,r}."""
    return _diurnal_windows(sc)


def _swing_windows(sc: TrafficScenario) -> list[int]:
    """Decade-ladder swings: sizes cycle through ``n_base`` x {1, 10,
    100, ...} up to ``spike_mult`` - with ``bucketing="pow2"`` the
    program count stays logarithmic in the swing and steady-state
    captures stay zero."""
    decades = max(1, int(math.log10(max(10.0, sc.spike_mult))) + 1)
    mults = [10.0 ** d for d in range(decades)]
    return [int(sc.n_base * mults[t % decades])
            for t in range(sc.n_windows)]


SCENARIOS: dict = {
    "constant": _constant_windows,
    "spike": _spike_windows,
    "diurnal": _diurnal_windows,
    "tenants": _tenants_windows,
    "carbon": _carbon_windows,
    "georegions": _georegions_windows,
    "geotenants": _geotenants_windows,
    "swing": _swing_windows,
}


def scenario_windows(sc: TrafficScenario) -> list[int]:
    """Per-window request counts for a scenario; with tenants every
    count is rounded down to whole equal tenant blocks."""
    try:
        make = SCENARIOS[sc.name]
    except KeyError:
        raise ValueError(f"unknown scenario {sc.name!r}: valid "
                         f"scenarios are {', '.join(SCENARIOS)}") from None
    out = []
    for n in make(sc):
        if sc.n_tenants > 1:  # keep tenant blocks equal-sized
            n = max(sc.n_tenants, n - n % sc.n_tenants)
        out.append(max(1, n))
    return out


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

    @property
    def total_spend(self) -> float:
        return float(sum(float(torch.sum(r.spend)) for r in self.windows))

    def overshoot(self, c_min: float) -> float:
        """Max relative spend overshoot vs. max(budget, n*c_min)."""
        worst = 0.0
        for r in self.windows:
            cap = max(r.budget, r.n_valid * c_min)
            worst = max(worst, float(torch.sum(r.spend)) / cap - 1.0)
        return worst


def run_stream(pipeline: ServingPipeline, sizes: list[int], source, *,
               lam_trace=None, budget_trace=None, scale_trace=None,
               forecast: bool = False, prefetch: int = 2, obs=None,
               clock=None, sync=None) -> StreamStats:
    """Serve ``sizes`` windows from ``source``: a ``RequestSource``
    (anything with ``window(t, n) -> WindowChunk``, whose chunk tables
    the windows gather), or a callable ``sample_window(t, n) -> (ctx,
    rows)`` indexing a materialized server.

    A chunk's ``shard`` (a ``MultihostSource``'s host slice) goes to
    ``serve_window`` with it.  ``prefetch`` > 0: one producer thread,
    running on its own CUDA
    stream, makes the chunks strictly in window order into a queue of
    depth ``prefetch``; its exception is raised in the serving thread.
    A chunk's tables reach the serving stream through its ``ready``
    event.  ``prefetch=0``: the sequential double-buffered path.
    ``lam_trace`` pins each window's entry price (parity checks);
    ``budget_trace`` and ``scale_trace`` set each window's budget and
    cost scale (vectors with tenants or regions, or the named dict
    form; see ``ServingPipeline.serve_window``).  ``forecast=True`` aims
    window t's nearline update at window t+1's budget and scale (the
    CI-forecast warm start: the published price lands where the next
    window needs it instead of lagging a swing by one window); with
    constant traces it changes nothing.
    ``clock`` (default ``time.perf_counter``) times host work: per
    window ``prep_ms`` (chunk production), ``stall_ms`` (the serving
    thread's wait for it) and ``submit_ms`` (``serve_window``).  Without
    ``sync`` the serving thread goes on while the device still runs;
    with ``sync`` (e.g. ``torch.cuda.synchronize``) it is called after
    every window, so ``submit_ms`` covers the device work too.  Either
    way the run ends by waiting for the card (the drain), so ``wall_s``
    covers every window's device work.

    ``obs`` (a ``repro_torch.obs.Obs``, default off) records spans
    (``prep`` on the producer thread, ``stall`` and ``serve`` on the
    serving thread, ``block_until_ready`` around the drain) and the
    per-window metrics, from host values only; after the drain it sets
    the price, spend and budget gauges and writes the JSONL flight log
    (``Obs.flush_stream``), the only device reads it makes.  Telemetry
    changes no number: runs with it on are bitwise runs with it off."""
    clock = clock or time.perf_counter
    obs = get_obs(obs)
    streaming = hasattr(source, "window")
    submit_ms: list[float] = []
    results: list[WindowResult] = []
    last = len(sizes) - 1
    m = obs.metrics
    windows_c = m.counter("greenflow_windows_total",
                          "serving windows completed")
    reqs_c = m.counter("greenflow_requests_total",
                       "requests served across windows")
    size_h = m.histogram("greenflow_window_size", "requests per window",
                         "1", log2_edges(1.0, float(1 << 22)))
    prep_h = m.histogram("greenflow_prep_ms", "host chunk production time",
                         "ms", MS_EDGES)
    stall_h = m.histogram("greenflow_stall_ms",
                          "serving-thread wait for an unready chunk", "ms",
                          MS_EDGES)
    submit_h = m.histogram("greenflow_submit_ms",
                           "serve_window dispatch time", "ms", MS_EDGES)
    h2d_c = m.counter("greenflow_h2d_bytes_total",
                      "host->device bytes uploaded", "bytes")
    compiles_c = m.counter("greenflow_compiles_total",
                           "window program captures")
    bucket_c = m.counter("greenflow_bucket_windows_total",
                         "windows served per padding bucket")

    def prep(t: int, n: int):
        with obs.span("prep", t=t, n=n):
            p0 = clock()
            if streaming:
                chunk = source.window(t, n)
                item = (chunk.ctx, chunk.rows, chunk.tables,
                        getattr(chunk, "ready", None), int(chunk.h2d_bytes),
                        getattr(chunk, "shard", None))
            else:
                ctx, rows = source(t, n)
                item = (ctx, rows, None, None, 0, None)
            return item, (clock() - p0) * 1e3

    def serve(t: int, item, stall: float) -> None:
        (ctx, rows, tables, ready, h2d, shard), prep_ms = item
        t_next = min(t + 1, last)  # the last window has nothing to aim at
        d0 = clock()
        with obs.span("serve", t=t, n=sizes[t]):
            res = pipeline.serve_window(
                ctx, rows, tables=tables, ready=ready, shard=shard,
                lam=None if lam_trace is None else lam_trace[t],
                budget=None if budget_trace is None else budget_trace[t],
                cost_scale=None if scale_trace is None else scale_trace[t],
                dual_budget=(budget_trace[t_next]
                             if forecast and budget_trace is not None
                             else None),
                dual_cost_scale=(scale_trace[t_next]
                                 if forecast and scale_trace is not None
                                 else None))
            if sync is not None:
                sync()
        submit = (clock() - d0) * 1e3
        submit_ms.append(submit)
        res.prep_ms += prep_ms
        res.stall_ms += stall
        res.h2d_bytes += h2d
        results.append(res)
        # per-window host-side metrics (never reads a device tensor)
        windows_c.inc()
        reqs_c.inc(sizes[t])
        size_h.observe(sizes[t])
        prep_h.observe(res.prep_ms)
        stall_h.observe(res.stall_ms)
        submit_h.observe(submit)
        h2d_c.inc(int(res.h2d_bytes))
        compiles_c.inc(int(res.compiles))
        if res.bucket is not None:
            bucket_c.labels(bucket=res.bucket).inc()
        if obs.interval > 0 and t % obs.interval == 0:
            print(obs.live_line(t, res, submit), flush=True)

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
                with obs.span("stall", t=t):
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
    dev = getattr(pipeline, "device", None)
    with obs.span("block_until_ready", windows=len(results)):
        if dev is not None and dev.type == "cuda":  # drain the card
            torch.cuda.synchronize(dev)
    stats = StreamStats(windows=results, sizes=list(sizes),
                        submit_ms=submit_ms, wall_s=clock() - t0)
    # gauges and the JSONL flight log: only after the drain, so their
    # device reads can no longer hold up the serving path
    obs.flush_stream(stats, cs=getattr(pipeline, "_cs", None),
                     ledger=getattr(pipeline, "ledger", None))
    return stats


def window_table(stats: StreamStats) -> list[str]:
    """Per-window report lines: n, spend/budget, lambda (a price per
    constraint with several), downgraded, revenue, host ms (prep +
    submit), stall ms, captures and bucket."""
    lines = [f"{'win':>4} {'n':>5} {'spend/budget':>13} {'lam':>11} "
             f"{'downgraded':>10} {'revenue':>9} {'ms':>9} {'stall':>8} "
             f"{'cap':>3} bucket"]
    for t, r in enumerate(stats.windows):
        lam = "/".join(f"{v:.4e}" for v in r.lam_after.reshape(-1).tolist())
        lines.append(
            f"{t:>4} {r.n_valid:>5} "
            f"{float(torch.sum(r.spend)) / r.budget:>13.4f} {lam:>11} "
            f"{int(r.downgraded):>10d} {float(np.sum(r.revenue_np)):>9.1f} "
            f"{r.prep_ms + stats.submit_ms[t]:>9.2f} {r.stall_ms:>8.2f} "
            f"{r.compiles:>3d} {r.bucket}")
    return lines
