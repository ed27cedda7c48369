"""Grid carbon-intensity traces: generators, CSV loading, resampling.

An :class:`IntensityTrace` is a uniformly sampled, piecewise-constant
CI(t) signal in gCO2e/kWh.  Traces are treated as CYCLIC (a canonical
"day" repeated), so a serving run longer than one trace period simply
wraps - the same convention real intensity feeds use when a forecast is
extended with the seasonal profile.

Synthetic generators cover the shapes the carbon-aware allocator is
benchmarked against:

  * ``constant_trace``   - today's single-number assumption (paper Eq. 2
    with CI = 615 g/kWh), the parity baseline;
  * ``diurnal_trace``    - a day sinusoid: dirty evening peak, clean
    night/midday trough (thermal-dominated grids);
  * ``solar_duck_trace`` - diurnal shape plus a midday solar "duck"
    depression and a steep evening ramp (solar-heavy grids, CAISO-like);
  * ``two_region_traces``- the same diurnal shape phase-shifted between
    two regions, for geo-shift scenarios (serve where it is night).

``load_ci_csv`` reads real exported intensity files in the two layouts
the ichnos trace->intensity pipeline parses (``parse_ci_intervals``):
``date,start,actual`` and the UK national-grid style
``date,start,end,forecast,actual,index``; the sampling period is
inferred from the first two chronological rows.
"""
from __future__ import annotations

import csv
import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class IntensityTrace:
    """Uniform, cyclic grid carbon-intensity samples [gCO2e/kWh]."""

    values: np.ndarray  # (T,) float64, > 0
    period_s: float  # seconds between consecutive samples
    name: str = "ci"

    def __post_init__(self):
        v = np.asarray(self.values, np.float64)
        object.__setattr__(self, "values", v)
        if v.ndim != 1 or v.size == 0:
            raise ValueError("intensity trace needs a 1-D non-empty series")
        if not np.all(np.isfinite(v)) or not np.all(v > 0):
            raise ValueError("carbon intensity must be finite and positive")
        if not self.period_s > 0:
            raise ValueError(f"period_s must be positive, got {self.period_s}")

    def __len__(self) -> int:
        return int(self.values.size)

    @property
    def span_s(self) -> float:
        """Length of one cycle in seconds."""
        return self.period_s * len(self)

    def at(self, t_s: float) -> float:
        """Piecewise-constant CI at time ``t_s`` seconds (cyclic)."""
        idx = int(math.floor(t_s / self.period_s)) % len(self)
        return float(self.values[idx])

    def resample(self, n_windows: int, window_s: float,
                 *, phase_s: float = 0.0) -> np.ndarray:
        """CI per serving window: window t covers [t*window_s, (t+1)*...).

        Each window takes the MEAN of the trace over its span (exact for
        the piecewise-constant signal), so a 6 h window over an hourly
        trace sees the 6-hour average, not one sampled hour.  ``phase_s``
        shifts the trace relative to window 0 (traffic-vs-grid offset
        experiments).
        """
        if n_windows <= 0:
            raise ValueError(f"n_windows must be positive, got {n_windows}")
        return np.array([self.window_mean(phase_s + t * window_s, window_s)
                         for t in range(n_windows)], np.float64)

    def window_mean(self, lo_s: float, window_s: float) -> float:
        """Mean CI over [lo_s, lo_s + window_s) - exact for the
        piecewise-constant signal (integrate the step function)."""
        hi_s = lo_s + window_s
        i0 = math.floor(lo_s / self.period_s)
        i1 = math.ceil(hi_s / self.period_s)
        acc = 0.0
        for i in range(i0, i1):
            seg_lo = max(lo_s, i * self.period_s)
            seg_hi = min(hi_s, (i + 1) * self.period_s)
            if seg_hi > seg_lo:
                acc += self.values[i % len(self)] * (seg_hi - seg_lo)
        return acc / window_s

    def mean(self) -> float:
        return float(self.values.mean())


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------

HOUR_S = 3600.0


def constant_trace(ci: float = 615.0, *, n: int = 24,
                   period_s: float = HOUR_S) -> IntensityTrace:
    """The paper's constant-CI world (Eq. 2 default 615 g/kWh)."""
    return IntensityTrace(np.full(n, float(ci)), period_s, name="constant")


def _check_day_span(n: int, period_s: float) -> None:
    """The day-shaped generators are cyclic over exactly 24 h; any other
    span would wrap mid-curve (discontinuity, skewed mean) silently."""
    if abs(n * period_s - 24.0 * HOUR_S) > 1e-6:
        raise ValueError(
            f"n*period_s must span one day (86400 s) for a day-curve "
            f"generator, got {n} x {period_s} s = {n * period_s} s; "
            f"pick n = {int(round(24.0 * HOUR_S / period_s))}")


def diurnal_trace(mean: float = 450.0, *, rel_amplitude: float = 0.45,
                  peak_hour: float = 19.0, n: int = 24,
                  period_s: float = HOUR_S) -> IntensityTrace:
    """Day sinusoid: CI peaks at ``peak_hour`` (evening demand ramp) and
    troughs 12 h away; ``rel_amplitude`` is the peak deviation / mean."""
    if not 0 <= rel_amplitude < 1:
        raise ValueError("rel_amplitude must be in [0, 1)")
    _check_day_span(n, period_s)
    hours = np.arange(n) * (period_s / HOUR_S)
    v = mean * (1.0 + rel_amplitude
                * np.cos(2.0 * np.pi * (hours - peak_hour) / 24.0))
    return IntensityTrace(v, period_s, name="diurnal")


def solar_duck_trace(mean: float = 450.0, *, rel_amplitude: float = 0.35,
                     solar_dip: float = 0.35, dip_hour: float = 13.0,
                     dip_width_h: float = 3.0, peak_hour: float = 19.0,
                     n: int = 24, period_s: float = HOUR_S) -> IntensityTrace:
    """The solar "duck": diurnal base minus a Gaussian midday depression
    (solar flooding the grid) which steepens the evening ramp.  The curve
    is floored at 10% of ``mean`` so intensity stays physical."""
    _check_day_span(n, period_s)
    base = diurnal_trace(mean, rel_amplitude=rel_amplitude,
                         peak_hour=peak_hour, n=n, period_s=period_s).values
    hours = np.arange(n) * (period_s / HOUR_S)
    # cyclic hour distance to the dip center
    d = np.minimum(np.abs(hours % 24.0 - dip_hour),
                   24.0 - np.abs(hours % 24.0 - dip_hour))
    dip = mean * solar_dip * np.exp(-0.5 * (d / dip_width_h) ** 2)
    v = np.maximum(base - dip, 0.1 * mean)
    return IntensityTrace(v, period_s, name="solar_duck")


def two_region_traces(mean: float = 450.0, *, offset_h: float = 8.0,
                      rel_amplitude: float = 0.45, n: int = 24,
                      period_s: float = HOUR_S
                      ) -> dict[str, IntensityTrace]:
    """Two grids with the same day shape ``offset_h`` hours apart (e.g.
    EU vs US-west): the geo-shift scenario serves each window from
    whichever region is currently greener."""
    a = diurnal_trace(mean, rel_amplitude=rel_amplitude, n=n,
                      period_s=period_s)
    b = diurnal_trace(mean, rel_amplitude=rel_amplitude,
                      peak_hour=19.0 + offset_h, n=n, period_s=period_s)
    return {"region_a": IntensityTrace(a.values, period_s, name="region_a"),
            "region_b": IntensityTrace(b.values, period_s, name="region_b")}


# ---------------------------------------------------------------------------
# CSV loading (ichnos parse_ci_intervals layouts)
# ---------------------------------------------------------------------------


def _parse_minutes(date: str, start: str) -> int:
    """'YYYY-MM-DD' + 'HH:MM' -> minutes since epoch-less day origin.
    Only DELTAS matter (period inference), so days are taken as 1440 min
    apart without touching timezone-dependent epoch conversion."""
    y, m, d = (int(x) for x in date.strip().split("-"))
    hh, mm = (int(x) for x in start.strip().split(":")[:2])
    # proleptic day number is overkill; a month-agnostic ordinal is fine
    # for period inference within one exported file
    from datetime import date as _date
    return _date(y, m, d).toordinal() * 1440 + hh * 60 + mm


def load_ci_csv(path: str, *, value_col: str | None = None,
                name: str | None = None) -> IntensityTrace:
    """Load an exported grid-intensity CSV as an :class:`IntensityTrace`.

    Accepts the two layouts ichnos' ``parse_ci_intervals`` reads:
    ``date,start,actual`` and ``date,start,end,forecast,actual,index``
    (UK carbon-intensity exports).  The value column is ``actual`` (or
    ``value``) unless ``value_col`` overrides it; the sampling period is
    inferred from the smallest positive timestamp delta and every row
    must land on that grid.  Missing/blank samples are filled by the
    previous value (the feed convention for short gaps).
    """
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        fields = [c.strip().lower() for c in (reader.fieldnames or [])]
        rows = list(reader)
    if not rows:
        raise ValueError(f"no data rows in {path}")
    if "date" not in fields or "start" not in fields:
        raise ValueError(f"{path}: expected 'date' and 'start' columns, "
                         f"got {fields}")
    col = value_col
    if col is None:
        for cand in ("actual", "value"):
            if cand in fields:
                col = cand
                break
    if col is None or col.lower() not in fields:
        raise ValueError(f"{path}: no intensity value column "
                         f"('actual'/'value') in {fields}")

    def get(row, key):
        for k, v in row.items():
            if k is not None and k.strip().lower() == key:
                return v
        return None

    stamps: list[tuple[int, float]] = []
    for r in rows:
        t = _parse_minutes(get(r, "date"), get(r, "start"))
        raw = get(r, col.lower())
        v = float(raw) if raw not in (None, "") else math.nan
        stamps.append((t, v))
    stamps.sort(key=lambda x: x[0])
    deltas = sorted({b - a for (a, _), (b, _) in zip(stamps, stamps[1:])
                     if b > a})
    if not deltas:
        raise ValueError(f"{path}: cannot infer a sampling period")
    period_min = deltas[0]
    if any(d % period_min for d in deltas):
        raise ValueError(f"{path}: non-uniform sampling, deltas={deltas} min")
    t0 = stamps[0][0]
    steps = (stamps[-1][0] - t0) // period_min + 1
    by_t = {t: v for t, v in stamps}
    values = np.empty(steps, np.float64)
    prev = math.nan
    for i in range(steps):
        v = by_t.get(t0 + i * period_min, math.nan)
        if math.isnan(v):
            v = prev  # forward-fill gaps
        if math.isnan(v):
            raise ValueError(f"{path}: leading sample is missing/blank")
        values[i] = prev = v
    import os
    return IntensityTrace(values, period_min * 60.0,
                          name=name or os.path.splitext(
                              os.path.basename(path))[0])
