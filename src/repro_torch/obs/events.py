"""Per-window JSONL event log: the flight-recorder record of a run.

The JAX package's rows, key for key.  ``bucket`` is the port's window
program key ``[b, padded]`` and ``compiles`` counts the CUDA graph
captures the window caused (``WindowResult.compiles``).

One JSON object per served window, written after the stream has been
drained (device arrays are read only AFTER the run forces them, so the
exporter never injects a sync into the response path):

    {"window": 3, "n": 160, "bucket": [160, false], "compiles": 0,
     "lam": {"tenant[0]": 1.1e-05, ..., "region_a": 0.0},
     "spend": {"tenant[0]": 1.9e8, ...}, "budget": {...},
     "flops": 2.4e9, "gco2e": 0.81, "revenue": 118.0,
     "h2d_bytes": 84480, "prep_ms": 11.2, "stall_ms": 0.0,
     "submit_ms": 2.9, "downgraded": 0}

``lam``/``spend``/``budget`` are keyed by the pipeline's compiled
ConstraintSpec axis names (``CompiledSpec.k_names`` /
``budget_names``), so a multi-axis run (geotenants) logs every dual
price and every per-axis spend-vs-budget by name.  ``gco2e`` is metered
through the pipeline's CarbonLedger when one is attached (operational
grams at that window's CI), else null.

The log appends across ``run_stream`` calls - a serving process writes
one growing JSONL file - and each line is self-contained, so the file
tails cleanly into any log pipeline.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.pfec import energy_from_flops


def _names_or(names, fallback: str) -> tuple[str, ...]:
    return tuple(names) if names else (fallback,)


def _host_np(x) -> np.ndarray:
    """Host value of a tensor (read through ``.detach().cpu()``, a
    device read: call it only after the stream has been drained);
    NumPy arrays and Python values pass straight through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _axis_dict(names, values) -> dict | None:
    """Zip axis names with a scalar-or-vector value into {name: float}."""
    if values is None:
        return None
    arr = np.asarray(values, np.float64).reshape(-1)
    names = tuple(names)
    if len(arr) != len(names):  # scalar broadcast over one axis name
        if arr.size == 1:
            arr = np.full(len(names), float(arr[0]))
        else:
            return {f"k{i}": float(v) for i, v in enumerate(arr)}
    return {n: float(v) for n, v in zip(names, arr)}


def window_event(t: int, result, submit_ms: float | None = None, *,
                 cs=None, ledger=None, host: str | None = None) -> dict:
    """One WindowResult -> one JSON-able event row.

    ``cs`` is the pipeline's ``CompiledSpec`` (names the lam/spend/
    budget axes); ``ledger`` an optional CarbonLedger used to meter the
    window's operational gCO2e at its CI; ``host`` tags the row with
    the writing process's label in a multi-host run (each host logs its
    OWN slice of every window - n/revenue/h2d are per-host there, while
    lam/spend/budget are the globally stitched values every host agrees
    on).  Reads device arrays - call only after the stream has been
    drained.
    """
    lam_names = _names_or(getattr(cs, "k_names", ()), "global")
    bud_names = _names_or(getattr(cs, "budget_names", ()), "global")

    lam = _axis_dict(lam_names, _host_np(result.lam_after))
    if result.tr_spend is not None:  # geotenants: tenant + region axes
        tr = _host_np(result.tr_spend)
        spend = _axis_dict(bud_names,
                           np.concatenate([tr.sum(axis=1),
                                           tr.sum(axis=0)]))
    elif result.region_spend is not None:
        spend = _axis_dict(bud_names, _host_np(result.region_spend))
    elif result.tenant_spend is not None:
        spend = _axis_dict(bud_names, _host_np(result.tenant_spend))
    else:
        spend = {"global": float(np.sum(_host_np(result.spend)))}
    budget = _axis_dict(
        bud_names,
        result.k_budget if result.k_budget is not None else result.budget)

    flops = (None if result.flops is None
             else float(_host_np(result.flops)))
    gco2e = None
    if ledger is not None and flops is not None:
        gco2e = energy_from_flops(flops, ledger.cfg) * ledger.window_ci(t)

    row = {} if host is None else {"host": str(host)}
    row.update({
        "window": int(t),
        "n": int(result.n_valid),
        "bucket": (None if result.bucket is None
                   else list(result.bucket)),
        "compiles": int(result.compiles),
        "lam": lam,
        "spend": spend,
        "budget": budget,
        "flops": flops,
        "gco2e": gco2e,
        "revenue": float(np.sum(result.revenue_np)),
        "downgraded": int(result.downgraded),
        "h2d_bytes": int(result.h2d_bytes),
        "prep_ms": round(float(result.prep_ms), 3),
        "stall_ms": round(float(result.stall_ms), 3),
        "submit_ms": (None if submit_ms is None
                      else round(float(submit_ms), 3)),
    })
    return row


class WindowEventLog:
    """Appends one JSON line per window to ``path`` (file and parent
    directory created on first write; successive runs keep appending,
    with ``window`` numbered per run)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.rows_written = 0

    def write_rows(self, rows: list[dict]) -> None:
        if not rows:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        self.rows_written += len(rows)
