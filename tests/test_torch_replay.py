"""The replay source and the serving API's ``guard=`` and ``lam_init=``:
the port against the JAX package on the ``system_exp`` stack carried
over (``tests/torch_system.py``).

  * a universe saved by either package's ``TableReplaySource.save``
    loads in the other, windows bit for bit (users, contexts, tables);
  * the port's ``from_server`` replay, its memmapped reload and the
    materialized rows serve bitwise-equal windows over a 3x spike, plain
    and geotenants (``tests/test_request_source.py``'s gates);
  * an unguarded window equals the JAX one at a pinned price, fed the
    JAX reward matrix: decisions and revenue exact, spend within 1e-6;
  * the first window's price is the ``lam_init`` keyword's, as in the
    JAX pipeline, never ``dual_cfg.lam_init``.
"""
import numpy as np
import pytest
import torch

import torch_system
from repro.core.primal_dual import DualDescentConfig as JDualCfg
from repro.data.request_source import TableReplaySource as JReplay
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.spec import ConstraintSpec as JSpec
from repro.serving.spec import GlobalAxis as JGlobal
from repro.serving.spec import RegionAxis as JRegion
from repro.serving.spec import TenantAxis as JTenant
from repro_torch.core.primal_dual import DualDescentConfig
from repro_torch.data.request_source import TableReplaySource
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.spec import (ConstraintSpec, GlobalAxis,
                                      RegionAxis, TenantAxis)
from repro_torch.serving.stream import (TrafficScenario, run_stream,
                                        scenario_windows)

SEED = 7


@pytest.fixture(scope="module")
def sys(system_exp, system_reward):
    return torch_system.carry(system_exp, system_reward)


@pytest.fixture(scope="module")
def replay(sys):
    return TableReplaySource.from_server(sys.tserver, sys.texp.ctx_eval,
                                         seed=SEED)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_window(a, b, tag):
    np.testing.assert_array_equal(a.users, b.users, err_msg=tag)
    np.testing.assert_array_equal(a.ctx, b.ctx, err_msg=tag)
    for k in ("p", "ck"):
        x, y = _np(a.tables[k]), _np(b.tables[k])
        assert x.dtype == y.dtype, tag
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {k}")


# ---------------------------------------------------------------------------
# The saved universe crosses between the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_universe_loads_in_the_other_package(sys, replay, tmp_path,
                                                   writer):
    jsrc = JReplay.from_server(sys.jserver, sys.jexp.ctx_eval, seed=SEED)
    path = str(tmp_path / "universe")
    (jsrc if writer == "jax" else replay).save(path)
    jdisk = JReplay.load(path, sys.jexp.chains, seed=SEED)
    tdisk = TableReplaySource.load(path, sys.tchains, seed=SEED,
                                   device="cpu")
    assert isinstance(tdisk.p_sorted, np.memmap) and not tdisk.device_tables
    assert tdisk.n_users == jdisk.n_users == len(sys.jexp.ctx_eval)
    for t, n in ((0, 40), (3, 96), (5, 1)):
        want = jsrc.window(t, n)
        _same_window(tdisk.window(t, n), want, f"{writer} disk w{t}")
        _same_window(replay.window(t, n), want, f"{writer} memory w{t}")
        _same_window(tdisk.window(t, n), jdisk.window(t, n),
                     f"{writer} both disks w{t}")


def test_replay_source_checks_its_tables(sys, replay):
    with pytest.raises(ValueError, match="must match table users"):
        TableReplaySource(replay.ctx[:-1], replay.p_sorted,
                          replay.clicks_sorted, sys.tchains,
                          n_items=replay.n_items, expose=replay.expose,
                          device="cpu")
    with pytest.raises(ValueError, match="compact layout"):
        TableReplaySource(replay.ctx, replay.p_sorted[:, :, :-1],
                          replay.clicks_sorted[:, :, :-1], sys.tchains,
                          n_items=replay.n_items, expose=replay.expose,
                          device="cpu")


def test_device_tables_upload_once(sys, replay):
    """The in-memory replay puts its universe on the device once: the
    first window's h2d counts the tables and the arrivals, later windows
    only their arrivals (4 bytes each); the memmapped form copies
    nothing itself."""
    src = TableReplaySource.from_server(sys.tserver, sys.texp.ctx_eval,
                                        seed=SEED)
    assert src.device_tables
    g, u, cap = src.p_sorted.shape
    first, second = src.window(0, 40), src.window(1, 24)
    assert first.h2d_bytes == 2 * g * u * cap * 4 + 40 * 4
    assert second.h2d_bytes == 24 * 4
    assert isinstance(first.tables["p"], torch.Tensor)
    assert src.window(2, 0).tables["p"].shape == (g, 0, cap)


# ---------------------------------------------------------------------------
# Replay == memmapped reload == materialized rows, bitwise
# ---------------------------------------------------------------------------


def _geotenants_case(chains):
    per_req = 0.5 * float(chains.costs.max())
    sizes = [48, 96, 48]
    budgets = [np.concatenate([np.full(2, per_req * n / 2),
                               np.full(2, 0.6 * per_req * n)]).astype(
        np.float32) for n in sizes]
    scales = [np.array([1.0, 1.3], np.float32)] * len(sizes)
    axes = [TenantAxis((per_req * 24, per_req * 24), priced=True),
            RegionAxis(2), GlobalAxis(pricing="carbon")]
    return sizes, axes, dict(budget_trace=budgets, scale_trace=scales)


@pytest.mark.parametrize("mode", ["plain", "geotenants"])
def test_replay_memmap_and_rows_serve_bitwise_equal(sys, replay, tmp_path,
                                                    mode):
    chains = sys.tchains
    if mode == "plain":
        b = 48
        sizes = scenario_windows(TrafficScenario("spike", 6, b,
                                                 spike_mult=3.0))
        budget = 0.5 * float(chains.costs.max()) * b

        def make(server):
            return ServingPipeline(server, sys.tparams, sys.trcfg, budget,
                                   device="cpu")
        kw = {}
    else:
        sizes, axes, kw = _geotenants_case(chains)

        def make(server):
            return ServingPipeline.from_spec(
                server, sys.tparams, sys.trcfg, ConstraintSpec(axes),
                device="cpu")
    replay.save(str(tmp_path / "u"))
    disk = TableReplaySource.load(str(tmp_path / "u"), chains, seed=SEED,
                                  device="cpu")

    def rows(t, n):
        users = replay.arrivals(t, n)
        return sys.texp.ctx_eval[users], users

    runs = [run_stream(make(sys.tserver), sizes, rows, prefetch=0, **kw),
            run_stream(make(replay.universe), sizes, replay, prefetch=2,
                       **kw),
            run_stream(make(disk.universe), sizes, disk, prefetch=0, **kw)]
    fields = ["decisions", "revenue", "spend", "lam_after", "downgraded"]
    if mode == "geotenants":
        fields += ["regions", "tr_spend"]
    for other in runs[1:]:
        for t, (a, b_) in enumerate(zip(runs[0].windows, other.windows)):
            for f in fields:
                assert torch.equal(getattr(a, f), getattr(b_, f)), (t, f)
    assert runs[0].total_revenue > 0


# ---------------------------------------------------------------------------
# guard=False against the JAX package, at a pinned price
# ---------------------------------------------------------------------------


def _spec_cases(chains):
    c_max = float(chains.costs.max())
    return {
        "plain": (lambda m: [m.GlobalAxis(budget=0.3 * c_max * 64)], {}),
        "tenants": (lambda m: [m.TenantAxis((0.1 * c_max * 32,
                                             0.2 * c_max * 32),
                                            priced=True)], {}),
        "geo": (lambda m: [m.RegionAxis(2),
                           m.GlobalAxis(budget=0.3 * c_max * 64,
                                        pricing="carbon")],
                dict(budget=np.full(2, 0.15 * c_max * 64, np.float32),
                     cost_scale=np.array([1.0, 1.5], np.float32))),
    }


class _Axes:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("case", ["plain", "tenants", "geo"])
def test_unguarded_window_matches_jax(sys, case):
    axes, kw = _spec_cases(sys.tchains)[case]
    jax_m = _Axes(GlobalAxis=JGlobal, TenantAxis=JTenant, RegionAxis=JRegion)
    port_m = _Axes(GlobalAxis=GlobalAxis, TenantAxis=TenantAxis,
                   RegionAxis=RegionAxis)
    jpipe = JPipeline.from_spec(sys.jserver, sys.jparams, sys.jrcfg,
                                JSpec(axes(jax_m)), guard=False)
    tpipe = torch_system.FedPipeline.from_spec(
        sys, sys.tserver, ConstraintSpec(axes(port_m)), guard=False)
    guarded = torch_system.FedPipeline.from_spec(
        sys, sys.tserver, ConstraintSpec(axes(port_m)))
    rng = np.random.default_rng(3)
    n_eval = len(sys.texp.ctx_eval)
    downgraded = 0
    for t in range(3):
        rows = rng.integers(0, n_eval, 64)
        ctx = sys.texp.ctx_eval[rows]
        k = tpipe._cs.n_prices
        lam = (np.full(k, 2e-10 * (t + 1), np.float32) if k
               else np.float32(2e-10 * (t + 1)))
        j = jpipe.serve_window(ctx, rows, lam=lam, **kw)
        p = tpipe.serve_window(ctx, rows, lam=lam, **kw)
        g = guarded.serve_window(ctx, rows, lam=lam, **kw)
        downgraded += int(g.downgraded)
        np.testing.assert_array_equal(p.decisions_np, j.decisions_np)
        np.testing.assert_array_equal(p.revenue_np, j.revenue_np)
        if j.regions is not None:
            np.testing.assert_array_equal(p.regions_np, j.regions_np)
        assert int(p.downgraded) == int(j.downgraded) == 0
        np.testing.assert_allclose(float(torch.sum(p.spend)),
                                   float(np.sum(np.asarray(j.spend))),
                                   rtol=1e-6)
        assert (p.tenant_spend is None) == (j.tenant_spend is None)
        assert (p.region_spend is None) == (j.region_spend is None)
    assert downgraded > 0  # the same windows guarded do downgrade


# ---------------------------------------------------------------------------
# The starting price: the lam_init keyword, as in the JAX pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("priced", [False, True])
@pytest.mark.parametrize("start", ["dual_cfg", "keyword"])
def test_first_window_prices_at_lam_init(sys, priced, start):
    """``dual_cfg=DualDescentConfig(lam_init=0.5)`` without the keyword
    starts both pipelines at 0; the keyword ``lam_init=0.3`` starts both
    at 0.3 (one price, or a price a priced tenant)."""
    c_max = float(sys.tchains.costs.max())
    budget = 0.4 * c_max * 32
    if start == "dual_cfg":
        jkw, tkw = (dict(dual_cfg=JDualCfg(lam_init=0.5)),
                    dict(dual_cfg=DualDescentConfig(lam_init=0.5)))
    else:
        jkw = tkw = dict(lam_init=0.3)
    tb = np.full(2, budget / 2, np.float32) if priced else None
    mode = dict(tenant_budgets=tb, tenant_mode="priced") if priced else {}
    jpipe = JPipeline(sys.jserver, sys.jparams, sys.jrcfg, budget, **mode,
                      **jkw)
    tpipe = ServingPipeline(sys.tserver, sys.tparams, sys.trcfg, budget,
                            device="cpu", **mode, **tkw)
    rows = np.arange(32)
    ctx = sys.texp.ctx_eval[rows]
    j = jpipe.serve_window(ctx, rows)
    p = tpipe.serve_window(ctx, rows)
    want = np.asarray(j.lam_before)
    assert want.shape == ((2,) if priced else ())
    np.testing.assert_array_equal(p.lam_before.numpy(), want)
    assert float(want.reshape(-1)[0]) == (0.0 if start == "dual_cfg"
                                          else np.float32(0.3))
