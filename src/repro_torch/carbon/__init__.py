"""Carbon-aware allocation: traces, per-window ledger, gCO2e budgets.

The paper accounts energy/carbon with Lacoste et al. 2019 (its Eq. 1-2);
this package makes those equations *per-window, time-varying, and
decision-relevant* instead of a post-hoc constant-CI conversion.  The
mapping from the paper's quantities to ledger fields:

    paper Eq. 1   EC = PUE * (p_ram e_ram + p_cpu e_cpu + p_gpu e_gpu)
        -> WindowCarbonEntry.kwh            (realized window energy;
           device-hours e_(.) derived from metered FLOPs through the
           EnergyConfig throughput model, as in core.pfec)
        -> WindowCarbonEntry.baseline_kwh   (the all-max-chain
           counterfactual: every request on the costliest chain)

    paper Eq. 2   CE = EC * CI
        -> WindowCarbonEntry.gco2e          with CI = CI(t) from an
           IntensityTrace, not the constant 615 g/kWh
        -> WindowCarbonEntry.ci_g_per_kwh   (the CI(t) actually applied)

    paper Eq. 3 budget C (FLOPs per window)
        -> CarbonBudget.grams_per_window    (gCO2e per window) with
           effective chain costs c_j(t) = flops_j * kappa * CI(t), so
           the Eq. 10 argmax and Algorithm 1 dual price operate in
           carbon units (see carbon.controller)

    "saves ~5000 kWh and ~3 tCO2e per day" (paper §1/§5)
        -> CarbonLedger.report()["daily_saved_kwh" / "daily_saved_tco2e"]
           (recorded windows extrapolated to a 24 h day vs the
           all-max-chain baseline, emitted to results/carbon_report.csv)

Submodules: ``intensity`` (trace generators + ichnos-style CSV loader),
``ledger`` (per-window operational and embodied carbon metering with
per-stage and per-model attribution), ``controller`` (carbon-denominated
dual budgets).  The JAX package's ``repro.carbon``, ported: the same
numbers on the same decisions, the controller's price an f32 torch
scalar.
"""
import importlib

_LAZY = {
    "IntensityTrace": "repro_torch.carbon.intensity",
    "constant_trace": "repro_torch.carbon.intensity",
    "diurnal_trace": "repro_torch.carbon.intensity",
    "solar_duck_trace": "repro_torch.carbon.intensity",
    "two_region_traces": "repro_torch.carbon.intensity",
    "load_ci_csv": "repro_torch.carbon.intensity",
    "CarbonLedger": "repro_torch.carbon.ledger",
    "WindowCarbonEntry": "repro_torch.carbon.ledger",
    "CarbonBudget": "repro_torch.carbon.controller",
    "CarbonBudgetController": "repro_torch.carbon.controller",
    "carbon_costs": "repro_torch.carbon.controller",
    "grams_per_flop": "repro_torch.carbon.controller",
}

__all__ = list(_LAZY)


def __getattr__(name):  # PEP 562: `import repro_torch.carbon` stays light
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
