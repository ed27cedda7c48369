"""The port's carbon subsystem against the JAX package's ``repro.carbon``.

  * the intensity traces: every generator, ``resample``, ``window_mean``,
    ``at`` and ``load_ci_csv`` give the JAX package's values exactly;
  * the ledger fed identical decisions: the same entries, the same
    ``report()`` dict and byte-identical ``to_csv`` and
    ``geo_report_csv`` files; mixed ``record``/``record_result`` stays
    ordered; embodied carbon amortizes as in JAX;
  * ``CarbonBudget``'s arithmetic and ``schedule`` equal JAX's;
  * ``CarbonBudgetController`` under both pricings on seeded rewards:
    decisions, downgrades and spends exact, the price within 1e-3
    relative (the dual loop runs in f32 in another program), pinned to
    JAX's for the next window;
  * the fused carbon day (``run_stream`` with per-window budget and
    scale traces, with and without the CI forecast) on the tiny stack of
    ``tests/torch_tiny.py``, fed the JAX reward matrix at the JAX run's
    entry prices, each pipeline metering into its own package's ledger:
    request counts exact, kWh and gCO2e within 1e-5 relative, decisions
    exact under flops pricing (power-of-two chain costs: every f32 sum
    exact) and under carbon pricing (see the test for the rate);
  * at a constant intensity the port's carbon and flops pricings serve
    the port's FLOPs-budget day bit for bit (the twin of
    ``tests/test_carbon.py``'s parity gate), the pipeline and the host
    controller alike;
  * the CLI serves the three days on the CPU and writes each ledger's
    CSV where ``--carbon-report`` points.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch_tiny
from torch_system import one_thread  # noqa: F401 (a fixture)

from repro.carbon import controller as jctl
from repro.carbon import intensity as jint
from repro.carbon import ledger as jled
from repro.core import action_chain as jac
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.stream import run_stream as jrun_stream
from repro_torch.carbon import controller as tctl
from repro_torch.carbon import intensity as tint
from repro_torch.carbon import ledger as tled
from repro_torch.core import action_chain as tac
from repro_torch.core import budget as tbudget
from repro_torch.serving.pipeline import ServingPipeline as TPipeline
from repro_torch.serving.stream import run_stream as trun_stream

LAM_RTOL = 1e-3
HOUR_S = 3600.0

# ---------------------------------------------------------------------------
# Intensity traces
# ---------------------------------------------------------------------------

TRACES = {
    "constant": lambda m: m.constant_trace(615.0, n=24),
    "diurnal": lambda m: m.diurnal_trace(mean=450.0, rel_amplitude=0.4),
    "diurnal_half_hourly": lambda m: m.diurnal_trace(n=48, period_s=1800.0),
    "duck": lambda m: m.solar_duck_trace(mean=450.0),
    "duck_narrow": lambda m: m.solar_duck_trace(mean=300.0, solar_dip=0.6,
                                                dip_width_h=1.5),
    "region_a": lambda m: m.two_region_traces(offset_h=8.0)["region_a"],
    "region_b": lambda m: m.two_region_traces(offset_h=5.5)["region_b"],
    "arange": lambda m: m.IntensityTrace(np.arange(1.0, 25.0), HOUR_S),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_equal_jax(name):
    j, t = TRACES[name](jint), TRACES[name](tint)
    np.testing.assert_array_equal(t.values, j.values)
    assert (t.period_s, t.name, t.span_s, len(t), t.mean()) == \
        (j.period_s, j.name, j.span_s, len(j), j.mean())
    for n_w, window_s, phase_s in ((24, HOUR_S, 0.0), (26, HOUR_S, 0.0),
                                   (12, 2 * HOUR_S, 0.0),
                                   (7, 86400.0 / 7, 3 * HOUR_S),
                                   (5, 1234.5, 777.0)):
        np.testing.assert_array_equal(
            t.resample(n_w, window_s, phase_s=phase_s),
            j.resample(n_w, window_s, phase_s=phase_s))
    for lo in (0.0, 100.0, 3599.0, 50_000.0, 90_000.0):
        assert t.window_mean(lo, 5000.0) == j.window_mean(lo, 5000.0)
        assert t.at(lo) == j.at(lo)


@pytest.mark.parametrize("make,match", [
    (lambda m: m.IntensityTrace(np.array([1.0, -2.0]), 3600.0), "positive"),
    (lambda m: m.IntensityTrace(np.array([1.0, 2.0]), 0.0), "period_s"),
    (lambda m: m.diurnal_trace(rel_amplitude=1.5), "rel_amplitude"),
    (lambda m: m.diurnal_trace(n=24, period_s=1800.0), "span one day"),
    (lambda m: m.solar_duck_trace(n=12), "span one day"),
    (lambda m: m.constant_trace(0.0), "positive"),
])
def test_trace_validation_matches_jax(make, match):
    for mod in (jint, tint):
        with pytest.raises(ValueError, match=match):
            make(mod)


def test_load_ci_csv_equals_jax(tmp_path):
    """The UK national-grid layout (a blank sample forward-filled) and
    the plain layout across a day boundary load as in JAX; a non-uniform
    file fails in both."""
    uk = tmp_path / "uk.csv"
    uk.write_text(
        "date,start,end,forecast,actual,index\n"
        "2024-03-01,00:00,00:30,210,200,moderate\n"
        "2024-03-01,00:30,01:00,205,190,moderate\n"
        "2024-03-01,01:00,01:30,195,,low\n"
        "2024-03-01,01:30,02:00,180,170,low\n")
    simple = tmp_path / "simple.csv"
    simple.write_text("date,start,actual\n2024-03-01,00:00,300\n"
                      "2024-03-01,01:00,350\n2024-03-02,00:00,400\n")
    for path, kw in ((uk, {}), (uk, {"value_col": "forecast"}),
                     (simple, {"name": "grid"})):
        j, t = jint.load_ci_csv(str(path), **kw), tint.load_ci_csv(
            str(path), **kw)
        np.testing.assert_array_equal(t.values, j.values)
        assert (t.period_s, t.name) == (j.period_s, j.name)
    assert tint.load_ci_csv(str(uk)).values.tolist() == [200.0, 190.0,
                                                          190.0, 170.0]
    bad = tmp_path / "bad.csv"
    bad.write_text("date,start,actual\n2024-03-01,00:00,100\n"
                   "2024-03-01,00:07,110\n2024-03-01,00:10,120\n")
    for mod in (jint, tint):
        with pytest.raises(ValueError, match="non-uniform"):
            mod.load_ci_csv(str(bad))


# ---------------------------------------------------------------------------
# Carbon budgets and cost vectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["constant", "diurnal", "duck", "arange"])
def test_carbon_budget_equals_jax(name):
    jt, tt = TRACES[name](jint), TRACES[name](tint)
    for ci in (300.0, 615.0):
        assert tctl.grams_per_flop(ci) == jctl.grams_per_flop(ci)
    costs = np.array([1e6, 2e6, 4e6, 3.3e7])
    np.testing.assert_array_equal(tctl.carbon_costs(costs, 500.0),
                                  jctl.carbon_costs(costs, 500.0))
    for make in (lambda m, tr: m.CarbonBudget.from_flops(
                     1e9, tr, window_s=86400.0 / 7, phase_s=5000.0),
                 lambda m, tr: m.CarbonBudget.from_grams(
                     0.37, tr, ci_ref=500.0, window_s=HOUR_S)):
        j, t = make(jctl, jt), make(tctl, tt)
        assert (t.flops_ref, t.ci_ref, t.grams_per_window) == \
            (j.flops_ref, j.ci_ref, j.grams_per_window)
        for w in range(9):
            assert (t.ci(w), t.scale(w), t.flops_budget(w)) == \
                (j.ci(w), j.scale(w), j.flops_budget(w))
        js, ts = j.schedule(9), t.schedule(9)
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
    # the ratio form: a constant intensity admits today's FLOPs exactly
    cb = tctl.CarbonBudget.from_flops(1e9, tint.constant_trace(600.0))
    assert all(cb.flops_budget(w) == 1e9 for w in range(30))


# ---------------------------------------------------------------------------
# The ledger, fed identical decisions
# ---------------------------------------------------------------------------


def _chains(ac):
    return torch_tiny.chains(ac, torch_tiny.PAPER_FLOPS)


def _entry(e) -> dict:
    return dataclasses.asdict(e)


def _ledgers(make):
    return make(jled, jac), make(tled, tac)


def test_ledger_equals_jax_and_csvs_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    jchains = _chains(jac)
    decs = [rng.integers(0, jchains.n_chains, n) for n in (40, 17, 64, 1)]
    mk = {"region_a": lambda L, tr, ac: L.CarbonLedger(
              _chains(ac), tr, window_s=86400.0 / 4, phase_s=3600.0,
              embodied_g_per_device_h=L.DEFAULT_EMBODIED_G_PER_DEVICE_H,
              n_devices=3, name="region_a"),
          "region_b": lambda L, tr, ac: L.CarbonLedger(
              _chains(ac), tr, window_s=86400.0 / 4, name="region_b")}
    leds = {}
    for name, make in mk.items():
        j, t = (make(L, TRACES["diurnal"](I), ac) for L, I, ac in
                ((jled, jint, jac), (tled, tint, tac)))
        for w, d in enumerate(decs):
            if w % 2:
                assert _entry(t.record(d)) == _entry(j.record(d))
            else:  # the explicit window and intensity forms
                assert _entry(t.record(d, t=w, ci=321.5 + w)) == _entry(
                    j.record(d, t=w, ci=321.5 + w))
        assert [_entry(e) for e in t.entries] == [_entry(e)
                                                  for e in j.entries]
        assert t.report() == j.report()
        paths = [str(tmp_path / f"{name}_{p}.csv") for p in "jt"]
        j.to_csv(paths[0])
        t.to_csv(paths[1])
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
        leds[name] = (j, t)
    jg, tg = str(tmp_path / "jgeo.csv"), str(tmp_path / "tgeo.csv")
    jled.geo_report_csv({k: v[0] for k, v in leds.items()}, jg)
    tled.geo_report_csv({k: v[1] for k, v in leds.items()}, tg)
    data = open(tg, "rb").read()
    assert data == open(jg, "rb").read()
    assert data.startswith(b"region,window,ci_g_per_kwh")
    for mod in (jled, tled):
        with pytest.raises(ValueError, match="at least one ledger"):
            mod.geo_report_csv({}, str(tmp_path / "none.csv"))
        with pytest.raises(ValueError, match="empty"):
            mod.CarbonLedger(_chains(tac), tint.constant_trace()).report()


class _Parked:
    """A duck-typed WindowResult (the ledger reads ``decisions_np``)."""

    def __init__(self, d):
        self.decisions_np = d


def test_ledger_mixed_recording_stays_ordered():
    """Parked results drain before a direct record() infers its window
    index, in both packages alike."""
    out = []
    for L, I, ac in ((jled, jint, jac), (tled, tint, tac)):
        led = L.CarbonLedger(_chains(ac), I.IntensityTrace(
            np.array([100.0, 200.0, 300.0]), HOUR_S), window_s=HOUR_S)
        led.record_result(_Parked(np.zeros(5, np.int64)))
        led.record(np.ones(3, np.int64))
        led.record_result(_Parked(np.full(2, 7, np.int64)))
        out.append([_entry(e) for e in led.entries])
    assert out[1] == out[0]
    assert [e["window"] for e in out[1]] == [0, 1, 2]
    assert [e["ci_g_per_kwh"] for e in out[1]] == [100.0, 200.0, 300.0]


def test_ledger_embodied_amortization_equals_jax():
    rate, devs = jled.DEFAULT_EMBODIED_G_PER_DEVICE_H, 3
    assert tled.DEFAULT_EMBODIED_G_PER_DEVICE_H == rate
    assert tled.DAY_S == jled.DAY_S
    reps = []
    for L, I, ac in ((jled, jint, jac), (tled, tint, tac)):
        led = L.CarbonLedger(_chains(ac), I.constant_trace(500.0),
                             window_s=2 * HOUR_S,
                             embodied_g_per_device_h=rate, n_devices=devs)
        rng = np.random.default_rng(2)
        for _ in range(4):
            led.record(rng.integers(0, led.chains.n_chains, 16))
        reps.append(led.report())
    assert reps[1] == reps[0]
    assert reps[1]["embodied_gco2e"] == pytest.approx(4 * rate * devs * 2)
    assert reps[1]["daily_embodied_gco2e"] == pytest.approx(rate * devs * 24)


# ---------------------------------------------------------------------------
# The host-loop controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pricing", ["carbon", "flops"])
def test_controller_matches_jax(pricing):
    """Both controllers on the same seeded rewards over a diurnal day:
    decisions, downgrades, spends and FLOPs exact; the price within
    1e-3, then pinned to JAX's for the next window.  Each meters into
    its own package's ledger: the entries equal."""
    jchains, tchains = (torch_tiny.chains(ac, torch_tiny.POW2_FLOPS)
                        for ac in (jac, tac))
    n = 48
    flops = 0.35 * float(jchains.costs.max()) * n
    jcb = jctl.CarbonBudget.from_flops(flops, jint.diurnal_trace(),
                                       window_s=86400.0 / 6)
    tcb = tctl.CarbonBudget.from_flops(flops, tint.diurnal_trace(),
                                       window_s=86400.0 / 6)
    jl = jled.CarbonLedger(jchains, jcb.trace, window_s=jcb.window_s)
    tl = tled.CarbonLedger(tchains, tcb.trace, window_s=tcb.window_s)
    j = jctl.CarbonBudgetController(jchains, jcb, pricing=pricing,
                                    ledger=jl)
    t = tctl.CarbonBudgetController(tchains, tcb, pricing=pricing,
                                    ledger=tl)
    rng = np.random.default_rng(3)
    downgraded = 0
    for _ in range(6):
        r = (rng.random((n, jchains.n_chains)) * 3.0).astype(np.float32)
        np.testing.assert_array_equal(t.step_window(r), j.step_window(r))
        js, ts = j.stats[-1], t.stats[-1]
        assert (ts.n_requests, ts.ci_g_per_kwh, ts.flops, ts.spend_g,
                ts.budget_g, ts.downgraded) == (
            js.n_requests, js.ci_g_per_kwh, js.flops, js.spend_g,
            js.budget_g, js.downgraded)
        np.testing.assert_allclose(ts.lam, js.lam, rtol=LAM_RTOL)
        t.lam = torch.tensor(float(j.lam))
        downgraded += ts.downgraded
    assert downgraded > 0  # the guard acted on the dirty-grid windows
    np.testing.assert_array_equal(t.spend_trace_g(), j.spend_trace_g())
    assert [_entry(e) for e in tl.entries] == [_entry(e)
                                               for e in jl.entries]


def test_controller_pricing_validation_and_from_spec():
    from repro_torch.serving import spec as tspec

    chains = _chains(tac)
    tr = tint.constant_trace()
    cb = tctl.CarbonBudget.from_flops(1e9, tr)
    with pytest.raises(ValueError, match="pricing"):
        tctl.CarbonBudgetController(chains, cb, pricing="joules")
    ctl = tctl.CarbonBudgetController.from_spec(
        chains, tspec.ConstraintSpec([tspec.GlobalAxis(
            budget=2e9, pricing="carbon")]), tr, window_s=HOUR_S)
    assert (ctl.budget.flops_ref, ctl.pricing) == (2e9, "carbon")
    assert ctl.lam.dtype == torch.float32 and float(ctl.lam) == 0.0
    with pytest.raises(ValueError, match="plain single-budget"):
        tctl.CarbonBudgetController.from_spec(
            chains, tspec.ConstraintSpec([
                tspec.TenantAxis((1e9, 1e9)), tspec.GlobalAxis()]), tr)


def test_constant_ci_controller_is_the_flops_controller():
    """At a constant intensity both pricings decide as the port's
    FLOPs-budget ``BudgetController``, and flops pricing publishes its
    prices bit for bit."""
    chains = _chains(tac)
    b_f = 0.5 * float(chains.costs.max()) * 48
    cb = tctl.CarbonBudget.from_flops(b_f, tint.constant_trace(615.0),
                                      window_s=HOUR_S)
    ref = tbudget.BudgetController(chains, b_f)
    ctl_f = tctl.CarbonBudgetController(chains, cb, pricing="flops")
    ctl_c = tctl.CarbonBudgetController(chains, cb, pricing="carbon")
    rng = np.random.default_rng(3)
    for _ in range(5):
        r = (rng.random((48, chains.n_chains)) * 3.0).astype(np.float32)
        d = ref.step_window(r)
        np.testing.assert_array_equal(ctl_f.step_window(r), d)
        np.testing.assert_array_equal(ctl_c.step_window(r), d)
        assert ctl_f.stats[-1].lam == ref.stats[-1].lam
        assert ctl_f.stats[-1].downgraded == ref.stats[-1].downgraded
        np.testing.assert_allclose(ctl_c.stats[-1].flops,
                                   ref.stats[-1].spend, rtol=1e-12)


# ---------------------------------------------------------------------------
# The fused carbon day on the tiny stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    return torch_tiny.build(pow2=True)


def _day(stack, pricing, n_w=6, n=64, frac=0.3):
    """A diurnal carbon day: sizes, the per-window (budget, scale)
    traces of ``pricing``, the windows and both packages' budgets."""
    flops = frac * float(stack.jchains.costs.max()) * n
    window_s = 86400.0 / n_w
    jcb = jctl.CarbonBudget.from_flops(flops, jint.diurnal_trace(),
                                       window_s=window_s)
    tcb = tctl.CarbonBudget.from_flops(flops, tint.diurnal_trace(),
                                       window_s=window_s)
    sched = tcb.schedule(n_w)
    if pricing == "carbon":
        budgets, scales = sched["grams"], sched["scale"]
    else:
        budgets, scales = sched["flops_budget"], None
    wins = torch_tiny.windows(n_w, n=n, seed=5)
    return [n] * n_w, budgets, scales, (lambda t, m: wins[t]), jcb, tcb


@pytest.mark.parametrize("pricing,forecast", [
    ("flops", False), ("flops", True), ("carbon", False), ("carbon", True)])
def test_fused_carbon_day_matches_jax(stack, pricing, forecast):
    """The fused carbon day at the JAX run's entry prices, fed the JAX
    reward matrix, each package's pipeline metering its own ledger.

    Flops pricing is exact: power-of-two chain costs make every f32 sum
    the window takes exact.  Carbon pricing multiplies the costs by
    kappa * CI(t), which no power of two is, so the guard's f32 prefix
    sums could separate the packages at a window's margin (a gate of
    99.5 % of the requests would allow for it); on this day they agree
    on every request, and the test holds them to that."""
    sizes, budgets, scales, sample, jcb, tcb = _day(stack, pricing)
    jl = jled.CarbonLedger(stack.jchains, jcb.trace, window_s=jcb.window_s)
    tl = tled.CarbonLedger(stack.tchains, tcb.trace, window_s=tcb.window_s)
    jpipe = JPipeline(stack.jserver, stack.jparams, stack.jrcfg,
                      jcb.flops_ref, ledger=jl)
    jst = jrun_stream(jpipe, sizes, sample, budget_trace=budgets,
                      scale_trace=scales, forecast=forecast, prefetch=0)
    tpipe = torch_tiny.FedPipeline(stack, tcb.flops_ref, ledger=tl)
    lam_trace = [np.asarray(w.lam_before) for w in jst.windows]
    tst = trun_stream(tpipe, sizes, sample, lam_trace=lam_trace,
                      budget_trace=budgets, scale_trace=scales,
                      forecast=forecast, prefetch=0)
    same = total = downgraded = 0
    for jw, tw in zip(jst.windows, tst.windows):
        same += int((tw.decisions_np == jw.decisions_np).sum())
        total += tw.n_valid
        downgraded += int(tw.downgraded)
        np.testing.assert_allclose(tw.lam_after.numpy(),
                                   np.asarray(jw.lam_after), rtol=LAM_RTOL)
        if pricing == "flops":
            np.testing.assert_array_equal(tw.decisions_np, jw.decisions_np)
            assert float(tw.spend) == float(jw.spend)
            assert int(tw.downgraded) == int(jw.downgraded)
            np.testing.assert_array_equal(tw.revenue_np, jw.revenue_np)
    assert same / total == 1.0, same / total  # both pricings, this day
    assert downgraded > 0  # the gram cap binds on the dirty windows
    jr, tr = jl.report(), tl.report()
    assert (tr["n_windows"], tr["n_requests"]) == (jr["n_windows"],
                                                   jr["n_requests"])
    for key in ("flops", "kwh", "gco2e", "baseline_kwh", "baseline_gco2e",
                "daily_saved_kwh", "daily_saved_gco2e"):
        assert tr[key] == pytest.approx(jr[key], rel=1e-5), key
    for je, te in zip(jl.entries, tl.entries):
        assert te.n_requests == je.n_requests
        assert te.gco2e == pytest.approx(te.kwh * te.ci_g_per_kwh,
                                         rel=1e-12)
        assert te.ci_g_per_kwh == je.ci_g_per_kwh


def test_diurnal_carbon_day_respects_gram_cap(stack):
    """Carbon pricing on the port's own reward model: every window's
    gCO2e spend within max(gram budget, the floor) and equal to its
    FLOPs re-priced at the window's intensity; the ledger attached to
    the pipeline meters every window at its intensity."""
    sizes, budgets, scales, sample, _, cb = _day(stack, "carbon")
    led = tled.CarbonLedger(stack.tchains, cb.trace, window_s=cb.window_s)
    pipe = TPipeline(stack.tserver, stack.tparams, stack.trcfg,
                     cb.flops_ref, ledger=led, device="cpu")
    st = trun_stream(pipe, sizes, sample, budget_trace=budgets,
                     scale_trace=scales, prefetch=0)
    c_min = float(stack.tchains.costs.min())
    for t, r in enumerate(st.windows):
        cap = max(cb.grams_per_window, r.n_valid * c_min * scales[t])
        assert float(r.spend) <= cap * (1 + 1e-5)
        assert float(r.spend) == pytest.approx(float(r.flops) * scales[t],
                                               rel=1e-5)
    assert len(led._pending) == len(sizes)  # parked, nothing read yet
    assert [e.ci_g_per_kwh for e in led.entries] == list(
        cb.schedule(len(sizes))["ci"])
    assert [e.flops for e in led.entries] == [float(r.flops)
                                              for r in st.windows]


@pytest.mark.parametrize("pricing", ["carbon", "flops"])
def test_constant_ci_day_is_the_flops_day(stack, pricing):
    """At a constant intensity flops pricing (the ratio form: x / x ==
    1.0) serves the port's FLOPs-budget day bit for bit: decisions,
    spends, downgrades, revenue, FLOPs and the published prices.

    Carbon pricing is the same LP up to the positive scalar kappa * CI,
    but its prices and costs round in f32 at another scale, so a request
    at a window's margin may go the other way, in the JAX package as in
    the port: over these three 6-window days of 64 requests the JAX
    package's own carbon and FLOPs days differ on 1 request of 1,152 and
    the port's on 2.  The gate is 99.5 % of the requests for each, and
    every window's gram spend within its budget."""
    b_f = 0.5 * float(stack.tchains.costs.max()) * 64
    cb = tctl.CarbonBudget.from_flops(b_f, tint.constant_trace(600.0),
                                      window_s=HOUR_S)
    same = {"torch": 0, "jax": 0}
    total = 0
    for seed in (1, 2, 3) if pricing == "carbon" else (1,):
        pipes = {"torch": [TPipeline(stack.tserver, stack.tparams,
                                     stack.trcfg, b_f, device="cpu")
                           for _ in range(2)]}
        if pricing == "carbon":
            pipes["jax"] = [JPipeline(stack.jserver, stack.jparams,
                                      stack.jrcfg, b_f) for _ in range(2)]
        for t, (ctx, rows) in enumerate(torch_tiny.windows(6, n=64,
                                                           seed=seed)):
            for pkg, (ref, day) in pipes.items():
                r_ref = ref.serve_window(ctx, rows)
                if pricing == "flops":
                    r = day.serve_window(ctx, rows,
                                         budget=cb.flops_budget(t))
                    for name in ("decisions", "spend", "lam_after",
                                 "downgraded", "revenue", "flops"):
                        assert torch.equal(getattr(r, name),
                                           getattr(r_ref, name)), name
                else:
                    r = day.serve_window(ctx, rows,
                                         budget=cb.grams_per_window,
                                         cost_scale=cb.scale(t))
                    assert float(r.spend) <= cb.grams_per_window * (1 + 1e-6)
                same[pkg] += int((r.decisions_np == r_ref.decisions_np).sum())
            total += 64
        assert float(pipes["torch"][0].lam) > 0
    assert same["torch"] / total >= 0.995, same["torch"] / total
    if pricing == "carbon":
        assert same["jax"] / total >= 0.995, same["jax"] / total


# ---------------------------------------------------------------------------
# The CLI's carbon days on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario,extra", [
    ("carbon", ["--ci-trace", "duck", "--ci-forecast"]),
    ("carbon", ["--carbon-pricing", "flops", "--ci-phase-h", "6"]),
    ("georegions", ["--geo-split", "argmax", "--devices", "2"]),
    ("geotenants", ["--tenants", "2", "--tenant-mode", "priced"]),
])
def test_cli_serves_the_carbon_days(tmp_path, capsys, scenario, extra,
                                    one_thread):
    from repro_torch.launch import serve

    path = tmp_path / f"{scenario}.csv"
    assert serve.main(["--small", "--device", "cpu", "--source",
                       "generated", "--windows", "4",
                       "--requests", "32", "--users", "2000",
                       "--scenario", scenario, "--carbon-report",
                       str(path), *extra]) == 0
    out = capsys.readouterr().out
    lines = path.read_text().splitlines()
    geo = scenario != "carbon"
    assert lines[0].startswith("region,window," if geo else "window,")
    assert len(lines) == 1 + (2 if geo else 1) * 5  # 4 windows + TOTAL
    assert "all-max base" in out and "daily savings" in out
    assert "PFEC" in out and f"-> {path}" in out
    if scenario == "geotenants":
        assert "day totals, per tenant" in out


def test_cli_report_defaults_under_results_torch(monkeypatch, tmp_path):
    """The default report paths are the port's own, never the JAX
    package's committed ``results/carbon_report*.csv``."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(["--scenario", "carbon"])
    for name in ("carbon_report.csv", "carbon_report_geo.csv",
                 "carbon_report_geotenants.csv"):
        path = serve._report_path(args, name)
        assert path.endswith(os.path.join("results", "torch", name))
    monkeypatch.setattr(serve, "RESULTS", str(tmp_path))
    assert serve._report_path(args, "x.csv") == str(tmp_path / "x.csv")
