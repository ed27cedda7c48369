"""Observability: the flight recorder for the streaming serving path.

One ``Obs`` bundle threads three views of a run through the stack:

  * ``Obs.metrics`` - a ``MetricsRegistry`` (counters / gauges / log2
    histograms) replacing the scattered ad-hoc counters with one
    namespace.  Prometheus-text and JSON snapshot exporters.
  * ``Obs.tracer`` - host span tracing (``obs.span("prep")``) with a
    Chrome-trace-event exporter; a run opens in Perfetto with the
    serving thread and the ``chunk-prefetch`` thread on separate
    tracks, so the overlap/stall story is literally visible.
  * ``Obs.events`` - an optional per-window JSONL flight log (size,
    bucket, lam per named axis, spend vs budget per axis, FLOPs,
    gCO2e, h2d bytes, prep/stall/submit ms, recompile deltas).

Everything is opt-in and free when off: the shared ``NULL_OBS`` (what
``get_obs(None)`` returns, and what every instrumented constructor
defaults to) hands out stateless no-op instruments and spans - no
allocations, no locks, no branches beyond one method call - and the
telemetry parity tests pin that enabled runs are BITWISE identical
(decisions, lam traces, spends) to disabled runs: nothing in here reads
a device tensor until the stream has been drained, and every span is
host-side, outside the captured CUDA graphs.

The JAX package's bundle, ported: the same metric names, span names
and event-row keys; ``Tracer(annotate=True)`` opens
``torch.profiler.record_function`` ranges.

Metric namespace
----------------
All serving metrics live under the ``greenflow_`` prefix.  Labels are
free-form key/values; the conventional ones are ``axis`` (a
``CompiledSpec`` axis name such as ``tenant[3]`` or ``region_a``),
``bucket`` (padded window shape), ``tenant``, ``region``.

========================================  =========  ====== ===========
name                                      type       unit   labels
========================================  =========  ====== ===========
greenflow_windows_total                   counter    1      -
greenflow_requests_total                  counter    1      -
greenflow_window_size                     histogram  1      -
greenflow_prep_ms                         histogram  ms     -
greenflow_stall_ms                        histogram  ms     -
greenflow_submit_ms                       histogram  ms     -
greenflow_h2d_bytes_total                 counter    bytes  -
greenflow_compiles_total                  counter    1      -
greenflow_downgraded_total                counter    1      -
greenflow_bucket_windows_total            counter    1      bucket
greenflow_table_cache_hits_total          counter    1      -
greenflow_table_cache_misses_total        counter    1      -
greenflow_lambda                          gauge      1/cost axis
greenflow_spend                           gauge      FLOPs  axis
greenflow_budget                          gauge      FLOPs  axis
greenflow_flops_total                     counter    FLOPs  [name]
greenflow_energy_kwh_total                counter    kWh    [name]
greenflow_gco2e_total                     counter    g      [name]
greenflow_ledger_windows_total            counter    1      [name]
========================================  =========  ====== ===========

Counters/histograms are updated once per WINDOW on the serving thread
(never per request); lam/spend/budget gauges and the JSONL event log
are written once per RUN after the stream drains, because reading them
earlier would force a device sync mid-stream.  Carbon counters are
incremented when the ``CarbonLedger`` meters its parked windows
(lazily, at report time), keeping metering off the response path.
"""
from __future__ import annotations

from repro_torch.obs.events import WindowEventLog, window_event
from repro_torch.obs.env import env_info
from repro_torch.obs.metrics import (NULL_INSTRUMENT, NULL_REGISTRY,
                                     MetricsRegistry, log2_edges)
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, Tracer,
                                   merge_chrome_traces)

MS_EDGES = log2_edges(0.25, 8192.0)


class Obs:
    """The telemetry bundle handed to every instrumented component.

    ``Obs()`` is fully on (in-memory registry + tracer, no file
    sinks); attach ``events=WindowEventLog(path)`` for the JSONL
    flight log and call ``export(path)`` / ``tracer.write(path)`` for
    the Prometheus/Perfetto artifacts.  ``NULL_OBS`` is the shared
    disabled bundle - components take ``obs=None`` and normalize via
    ``get_obs``.
    """

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 events: WindowEventLog | None = None,
                 interval: int = 0, annotate: bool = False,
                 host: str | None = None):
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = (Tracer(annotate=annotate, process_label=host)
                       if tracer is None else tracer)
        self.events = events
        self.interval = int(interval)
        self.host = host  # per-host label of a multi-host run
        self.enabled = self.metrics.enabled or self.tracer.enabled

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    # -- end-of-run flush (safe: stream already drained) -----------------

    def flush_stream(self, stats, *, cs=None, ledger=None) -> None:
        """Set per-axis lam/spend/budget gauges from the final window
        and append one JSONL event per window.  Called by ``run_stream``
        AFTER its drain loop, so the device reads here never stall the
        serving path."""
        if not self.enabled or not stats.windows:
            return
        rows = [window_event(t, r, s, cs=cs, ledger=ledger,
                             host=self.host)
                for t, (r, s) in enumerate(zip(stats.windows,
                                               stats.submit_ms))]
        last = rows[-1]
        for metric, key in (("greenflow_lambda", "lam"),
                            ("greenflow_spend", "spend"),
                            ("greenflow_budget", "budget")):
            vals = last[key]
            if vals:
                g = self.metrics.gauge(metric)
                for axis, v in vals.items():
                    g.labels(axis=axis).set(v)
        if self.events is not None:
            self.events.write_rows(rows)

    def live_line(self, t: int, result, submit_ms: float) -> str:
        """Compact one-window terminal line (host-side fields only)."""
        return (f"[obs] w={t:<5d} n={int(result.n_valid):<7d} "
                f"bucket={result.bucket} prep={result.prep_ms:6.1f}ms "
                f"stall={result.stall_ms:6.1f}ms "
                f"submit={submit_ms:6.1f}ms "
                f"compiles={int(result.compiles)} "
                f"h2d={int(result.h2d_bytes)}B")

    # -- snapshot export --------------------------------------------------

    def export(self, metrics_out: str) -> tuple[str, str]:
        """Write the Prometheus text snapshot to ``metrics_out`` and the
        JSON snapshot next to it at ``metrics_out + '.json'``."""
        import json
        import os
        path = os.path.abspath(metrics_out)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.metrics.prometheus_text())
        jpath = path + ".json"
        with open(jpath, "w") as f:
            json.dump(self.metrics.snapshot(), f, indent=2)
        return path, jpath


NULL_OBS = Obs(metrics=NULL_REGISTRY, tracer=NULL_TRACER)


def get_obs(obs: Obs | None) -> Obs:
    """Normalize an optional ``obs`` argument: ``None`` -> ``NULL_OBS``."""
    return NULL_OBS if obs is None else obs


__all__ = [
    "Obs", "NULL_OBS", "get_obs",
    "MetricsRegistry", "NULL_REGISTRY", "NULL_INSTRUMENT", "log2_edges",
    "Tracer", "NULL_TRACER", "NULL_SPAN", "MS_EDGES",
    "merge_chrome_traces",
    "WindowEventLog", "window_event", "env_info",
]
