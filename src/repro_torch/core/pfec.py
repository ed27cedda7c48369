"""PFEC evaluation methodology (paper §3.2): Performance / FLOPs / Energy /
Carbon.  Energy follows Lacoste et al. 2019 (Eq. 1-2):

    EC = PUE * (p_ram*e_ram + p_cpu*e_cpu + p_gpu*e_gpu)      [kWh]
    CE = EC * CI                                              [gCO2e]

Offline we cannot meter wall power, so device usage e_(.) is derived from
the FLOPs the allocator actually spends, through a joules-per-FLOP
efficiency constant per device class (calibrated or spec-sheet), a
deviation from the paper's metered power.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class EnergyConfig:
    """Paper constants: PUE 1.67 (worldwide avg), CI 615 gCO2e/kWh."""

    pue: float = 1.67
    carbon_intensity_g_per_kwh: float = 615.0
    # device rated powers (W) - paper Eq. 1 terms
    p_ram_w: float = 20.0
    p_cpu_w: float = 105.0
    p_gpu_w: float = 250.0
    # sustained efficiency used to convert FLOPs -> device-hours.
    # (TPU v5e ~197 TF/s bf16 peak; serving fleets in the paper are CPU/GPU -
    # we expose the knob and default to a GPU-class 2e13 FLOP/s sustained.)
    sustained_flops_per_s: float = 2.0e13
    ram_cpu_fraction: float = 0.15  # fraction of device-hours billed to ram+cpu

    def __post_init__(self):
        if self.pue < 1.0:
            raise ValueError(
                f"pue must be >= 1.0 (total/IT power ratio), got {self.pue}")
        for name in ("carbon_intensity_g_per_kwh", "p_ram_w", "p_cpu_w",
                     "p_gpu_w", "sustained_flops_per_s"):
            v = getattr(self, name)
            if not v > 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.ram_cpu_fraction < 0:
            raise ValueError(f"ram_cpu_fraction must be >= 0, "
                             f"got {self.ram_cpu_fraction}")


@dataclass
class PFECReport:
    performance: float  # revenue@e (clicks)
    flops: float  # total FLOPs consumed
    energy_kwh: float
    carbon_g: float
    meta: dict = field(default_factory=dict)

    def as_row(self) -> dict:
        return {
            "performance": self.performance,
            "flops": self.flops,
            "energy_kwh": self.energy_kwh,
            "carbon_g": self.carbon_g,
            **self.meta,
        }


def _resolve(cfg: EnergyConfig | None) -> EnergyConfig:
    """One place builds the default config (a ``cfg=EnergyConfig()`` default
    arg would be evaluated once at import and silently pin its constants)."""
    return EnergyConfig() if cfg is None else cfg


def energy_from_flops(flops: float, cfg: EnergyConfig | None = None) -> float:
    """FLOPs -> kWh via Eq. 1 with usage-hours derived from throughput."""
    cfg = _resolve(cfg)
    hours = flops / cfg.sustained_flops_per_s / 3600.0
    e_gpu = hours
    e_cpu = hours * cfg.ram_cpu_fraction
    e_ram = hours * cfg.ram_cpu_fraction
    watts = (cfg.p_ram_w * e_ram + cfg.p_cpu_w * e_cpu + cfg.p_gpu_w * e_gpu)
    return cfg.pue * watts / 1000.0  # W*h -> kWh


def kwh_per_flop(cfg: EnergyConfig | None = None) -> float:
    """kappa: the (linear) Eq. 1 slope, kWh consumed per FLOP served."""
    return energy_from_flops(1.0, cfg)


def carbon_from_energy(kwh: float, cfg: EnergyConfig | None = None) -> float:
    """Eq. 2: CE = EC * CI  [gCO2e]."""
    return kwh * _resolve(cfg).carbon_intensity_g_per_kwh


def pfec_report(*, clicks: float, flops: float,
                cfg: EnergyConfig | None = None, **meta) -> PFECReport:
    cfg = _resolve(cfg)
    kwh = energy_from_flops(flops, cfg)
    return PFECReport(
        performance=float(clicks),
        flops=float(flops),
        energy_kwh=float(kwh),
        carbon_g=float(carbon_from_energy(kwh, cfg)),
        meta=meta,
    )


def revenue_at_e(click_labels: np.ndarray, ranked_items: np.ndarray,
                 e: int = 20) -> float:
    """Paper Eq. 11 for one request: clicks among the top-e exposed items.

    click_labels: (n_items,) 0/1 ground-truth clicks for the request's
    candidate set; ranked_items: indices ordered by the final stage.
    ``e`` past the ranking length exposes everything ranked; an empty
    ranking exposes nothing (0 clicks).  Labels of any numeric dtype or
    layout (views/slices) are accepted.
    """
    top = np.asarray(ranked_items, dtype=np.intp).reshape(-1)[:e]
    if top.size == 0:
        return 0.0
    return float(np.asarray(click_labels, dtype=np.float64)[top].sum())
