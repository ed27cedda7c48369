"""Per-window operational-carbon ledger for serving runs.

The seed converted total FLOPs to carbon once, after the run, at a
single grid intensity (``core.pfec``, CI=615).  The ledger instead
meters every serving window as it lands:

    kwh_t   = energy_from_flops(flops_t)          # Eq. 1
    gco2e_t = kwh_t * CI(t)                       # Eq. 2, CI time-varying

with the realized FLOPs attributed per cascade stage (recall / prerank
/ rank) and per model variant (DSSM / YDNN / DIN / DIEN), and a running
all-max-chain baseline (every request on the most expensive chain -
what a cascade without GreenFlow allocation would burn) so the daily
report states the repro's version of the paper's "saves ~5000 kWh and
3 tCO2e per day" headline.

Windows recorded through :meth:`CarbonLedger.record_result` (the
``ServingPipeline`` hook, called after the window's graphs are
launched) are metered LAZILY: the ledger parks the ``WindowResult`` and
only reads its device tensors when a report is requested, so metering
never makes the serving thread wait for the card.

EMBODIED carbon: the hardware's manufacturing footprint amortized over
its service life (the ichnos ``EmbodiedCarbon.py`` model - a constant
gCO2e per device-hour) accrues per window as
``embodied_g_per_device_h * n_devices * window_s / 3600`` regardless of
load, so reports and the CSV carry operational AND total footprints -
a serving day is never under-reported as operational-only.  The default
constant amortizes a ~1.3 tCO2e server manufacture over a 4-year life.

Geo serving keeps ONE ledger PER REGION (each metered at its region's
CI trace); ``geo_report_csv`` merges them into a single CSV with a
leading ``region`` column - the per-region attribution artifact.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch.carbon.intensity import IntensityTrace
from repro_torch.core.action_chain import ActionChainSet
from repro_torch.core.pfec import EnergyConfig, energy_from_flops
from repro_torch.obs import get_obs

DAY_S = 86400.0

# ichnos EmbodiedCarbon-style amortization constant: ~1.3 tCO2e server
# manufacture / (4 y * 365 d * 24 h) ~= 37 g per device-hour
DEFAULT_EMBODIED_G_PER_DEVICE_H = 37.0


@dataclass(frozen=True)
class WindowCarbonEntry:
    """One metered serving window (all energies kWh, all carbon gCO2e)."""

    window: int
    ci_g_per_kwh: float
    n_requests: int
    flops: float
    kwh: float
    gco2e: float
    baseline_flops: float  # all-max-chain counterfactual
    baseline_kwh: float
    baseline_gco2e: float
    embodied_gco2e: float = 0.0  # amortized manufacture, load-independent
    stage_flops: dict[str, float] = field(default_factory=dict)
    model_flops: dict[str, float] = field(default_factory=dict)

    @property
    def total_gco2e(self) -> float:
        """Operational + embodied footprint of the window."""
        return self.gco2e + self.embodied_gco2e


class CarbonLedger:
    """Meters realized per-window FLOPs into kWh / gCO2e at CI(t).

    Parameters
    ----------
    chains: the serving chain set; its per-stage (model, scale) structure
        drives the FLOPs attribution tables.
    trace: grid intensity; window t reads the trace mean over
        ``[phase_s + t*window_s, phase_s + (t+1)*window_s)``.
    cfg: Eq. 1 energy constants (default: fresh ``EnergyConfig``).
    window_s: serving-window length in seconds (sets the windows-per-day
        extrapolation of the daily report).
    embodied_g_per_device_h / n_devices: amortized embodied carbon
        accrued per window (0.0 disables the line; pass
        ``DEFAULT_EMBODIED_G_PER_DEVICE_H`` for the ichnos-style server
        constant).
    name: label used by multi-ledger (per-region) reports.
    """

    def __init__(self, chains: ActionChainSet, trace: IntensityTrace, *,
                 cfg: EnergyConfig | None = None, window_s: float = 3600.0,
                 phase_s: float = 0.0,
                 embodied_g_per_device_h: float = 0.0, n_devices: int = 1,
                 name: str = "serving", obs=None):
        self.obs = get_obs(obs)
        self.chains = chains
        self.trace = trace
        self.cfg = cfg or EnergyConfig()
        self.window_s = float(window_s)
        self.phase_s = float(phase_s)
        self.embodied_g_per_device_h = float(embodied_g_per_device_h)
        self.n_devices = int(n_devices)
        self.name = name
        self._entries: list[WindowCarbonEntry] = []
        self._pending: list = []  # WindowResults awaiting metering

        # attribution tables: stage_table (J, K) FLOPs of chain j's stage
        # k; model_table (J, M) the same FLOPs bucketed by model variant
        j_n, k_n = chains.chain_idx.shape[:2]
        self.stage_names = [st.name for st in chains.stages]
        names: list[str] = []
        for st in chains.stages:
            for m in st.models:
                if m.name not in names:
                    names.append(m.name)
        self.model_names = names
        self._stage_table = np.zeros((j_n, k_n), np.float64)
        self._model_table = np.zeros((j_n, len(names)), np.float64)
        for j in range(j_n):
            for k, st in enumerate(chains.stages):
                mi, si = chains.chain_idx[j, k]
                m = st.models[mi]
                f = m.fixed_flops + m.flops_per_item * st.item_scales[si]
                self._stage_table[j, k] = f
                self._model_table[j, names.index(m.name)] += f
        self._max_cost = float(chains.costs.max())

        # metered-total mirrors (labeled per ledger, e.g. per region)
        m = self.obs.metrics
        self._windows_c = m.counter(
            "greenflow_ledger_windows_total",
            "windows metered by the carbon ledger").labels(name=name)
        self._flops_c = m.counter(
            "greenflow_flops_total",
            "realized FLOPs metered", "FLOPs").labels(name=name)
        self._kwh_c = m.counter(
            "greenflow_energy_kwh_total",
            "operational energy metered (Eq. 1)", "kWh").labels(name=name)
        self._gco2e_c = m.counter(
            "greenflow_gco2e_total",
            "operational carbon metered (Eq. 2)", "g").labels(name=name)

    # -- recording ----------------------------------------------------------

    def window_ci(self, t: int) -> float:
        """CI (g/kWh) seen by window ``t``."""
        return self.trace.window_mean(self.phase_s + t * self.window_s,
                                      self.window_s)

    def record(self, decisions: np.ndarray, *, t: int | None = None,
               ci: float | None = None) -> WindowCarbonEntry:
        """Meter one window's realized decisions (valid requests only)."""
        # drain parked WindowResults first so this window's inferred index
        # lands after them (mixing record_result and record stays ordered)
        self._drain()
        dec = np.asarray(decisions).astype(np.intp).reshape(-1)
        t = len(self._entries) if t is None else t
        ci = self.window_ci(t) if ci is None else float(ci)
        n = int(dec.size)
        counts = np.bincount(dec, minlength=self.chains.n_chains) \
            .astype(np.float64)
        flops = float(counts @ self.chains.costs)
        kwh = energy_from_flops(flops, self.cfg)
        base_flops = n * self._max_cost
        base_kwh = energy_from_flops(base_flops, self.cfg)
        per_stage = counts @ self._stage_table  # (K,)
        per_model = counts @ self._model_table  # (M,)
        embodied = (self.embodied_g_per_device_h * self.n_devices
                    * self.window_s / 3600.0)
        entry = WindowCarbonEntry(
            window=t, ci_g_per_kwh=ci, n_requests=n, flops=flops, kwh=kwh,
            gco2e=kwh * ci, baseline_flops=base_flops, baseline_kwh=base_kwh,
            baseline_gco2e=base_kwh * ci, embodied_gco2e=embodied,
            stage_flops={s: float(v)
                         for s, v in zip(self.stage_names, per_stage)},
            model_flops={m: float(v)
                         for m, v in zip(self.model_names, per_model)})
        self._entries.append(entry)
        self._windows_c.inc()
        self._flops_c.inc(flops)
        self._kwh_c.inc(kwh)
        self._gco2e_c.inc(kwh * ci)
        return entry

    def record_result(self, result) -> None:
        """ServingPipeline hook: park a ``WindowResult`` for lazy metering
        (reading its decision array would force a device sync mid-stream)."""
        self._pending.append(result)

    def _drain(self) -> None:
        pending, self._pending = self._pending, []
        if not pending:
            return
        # lazy metering: this is the only place ledger work reads device
        # arrays, and it runs at report time, never inside the stream
        with self.obs.span("ledger", windows=len(pending)):
            for res in pending:
                self.record(res.decisions_np)

    @property
    def entries(self) -> list[WindowCarbonEntry]:
        self._drain()
        return self._entries

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        """Cumulative + per-day-extrapolated totals and baseline savings.

        ``daily_*`` figures scale the recorded windows to a 24 h day
        (``86400 / window_s`` windows) - the repro-scale analogue of the
        paper's ~5000 kWh / ~3 tCO2e per day claim.
        """
        entries = self.entries
        if not entries:
            raise ValueError("carbon ledger is empty: no windows recorded")
        tot = {k: float(sum(getattr(e, k) for e in entries))
               for k in ("flops", "kwh", "gco2e", "baseline_flops",
                         "baseline_kwh", "baseline_gco2e",
                         "embodied_gco2e")}
        n_w = len(entries)
        day_factor = (DAY_S / self.window_s) / n_w
        saved_kwh = tot["baseline_kwh"] - tot["kwh"]
        saved_g = tot["baseline_gco2e"] - tot["gco2e"]
        stage = {s: float(sum(e.stage_flops.get(s, 0.0) for e in entries))
                 for s in self.stage_names}
        model = {m: float(sum(e.model_flops.get(m, 0.0) for e in entries))
                 for m in self.model_names}
        total_g = tot["gco2e"] + tot["embodied_gco2e"]
        return {
            "n_windows": n_w,
            "window_s": self.window_s,
            "n_requests": int(sum(e.n_requests for e in entries)),
            "mean_ci_g_per_kwh": float(np.mean(
                [e.ci_g_per_kwh for e in entries])),
            **tot,
            "total_gco2e": total_g,
            "saved_kwh": saved_kwh,
            "saved_gco2e": saved_g,
            "daily_kwh": tot["kwh"] * day_factor,
            "daily_gco2e": tot["gco2e"] * day_factor,
            "daily_embodied_gco2e": tot["embodied_gco2e"] * day_factor,
            "daily_total_gco2e": total_g * day_factor,
            "daily_saved_kwh": saved_kwh * day_factor,
            "daily_saved_gco2e": saved_g * day_factor,
            "daily_saved_tco2e": saved_g * day_factor / 1e6,
            "stage_flops": stage,
            "model_flops": model,
        }

    def _csv_columns(self) -> list[str]:
        cols = ["window", "ci_g_per_kwh", "n_requests", "flops", "kwh",
                "gco2e", "baseline_flops", "baseline_kwh", "baseline_gco2e",
                "saved_kwh", "saved_gco2e"]
        cols += [f"stage_{s}_flops" for s in self.stage_names]
        cols += [f"model_{m}_flops" for m in self.model_names]
        cols += ["embodied_gco2e", "total_gco2e"]
        return cols

    def _csv_rows(self) -> list[list]:
        rows = []
        for e in self.entries:
            row = [e.window, e.ci_g_per_kwh, e.n_requests, e.flops,
                   e.kwh, e.gco2e, e.baseline_flops, e.baseline_kwh,
                   e.baseline_gco2e, e.baseline_kwh - e.kwh,
                   e.baseline_gco2e - e.gco2e]
            row += [e.stage_flops[s] for s in self.stage_names]
            row += [e.model_flops[m] for m in self.model_names]
            row += [e.embodied_gco2e, e.total_gco2e]
            rows.append(row)
        r = self.report()
        row = ["TOTAL", r["mean_ci_g_per_kwh"], r["n_requests"],
               r["flops"], r["kwh"], r["gco2e"], r["baseline_flops"],
               r["baseline_kwh"], r["baseline_gco2e"], r["saved_kwh"],
               r["saved_gco2e"]]
        row += [r["stage_flops"][s] for s in self.stage_names]
        row += [r["model_flops"][m] for m in self.model_names]
        row += [r["embodied_gco2e"], r["total_gco2e"]]
        rows.append(row)
        return rows

    def to_csv(self, path: str) -> str:
        """Write per-window rows + a TOTAL row; returns the path."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(",".join(self._csv_columns()) + "\n")
            for row in self._csv_rows():
                f.write(",".join(_fmt(v) for v in row) + "\n")
        return path


def geo_report_csv(ledgers: dict[str, "CarbonLedger"], path: str) -> str:
    """Merge per-region ledgers into one CSV with a ``region`` column.

    ``ledgers`` maps region name -> that region's ledger (each metered
    at its own CI trace) - the per-region attribution artifact of a
    geo-shifted serving day.  Rows keep each ledger's windows + TOTAL.
    """
    if not ledgers:
        raise ValueError("geo_report_csv needs at least one ledger")
    first = next(iter(ledgers.values()))
    cols = ["region"] + first._csv_columns()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for name, led in ledgers.items():
            if led._csv_columns() != cols[1:]:
                raise ValueError(f"ledger {name!r} has a different "
                                 f"column layout")
            for row in led._csv_rows():
                f.write(",".join(_fmt(v) for v in [name] + row) + "\n")
    return path


def _fmt(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return f"{float(v):.6g}"
