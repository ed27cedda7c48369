"""The port's ConstraintSpec and its window programs against the JAX
package's, on the tiny materialized stack of ``tests/test_spec.py``.

  * axis validation, the compiled spec's structure (mode, price and
    budget vectors' names and lengths) and the spec's device constructors
    equal the JAX package's;
  * every mode the spec compiles - plain, tenants shared and priced, geo
    with the flow split and the argmax, tenants x regions priced and
    shared - served at the JAX package's own entry prices, fed the JAX
    reward matrix: decisions, serving regions, revenue, downgrades and
    every spend (total, per tenant, per region, (T, R)) are EXACT.  The
    chains cost powers of two FLOPs per item and the region scales are
    powers of two, so every f32 sum a window makes is exact in any order.
    The published prices agree within 1e-3 relative: the dual loop
    divides and decays in f32 in another program;
  * per-window budgets and scales enter the programs as inputs: a
    window served after another of its bucket with other numbers equals
    the same window served first on a fresh pipeline, bit for bit;
  * the named (dict) budget form equals the positional one;
  * no mode's window program reads a device value on the host.
"""
import numpy as np
import pytest
import torch
import torch_tiny
from torch.utils._python_dispatch import TorchDispatchMode

from repro.serving import spec as jspec
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro_torch.serving import spec as tspec
from repro_torch.serving.pipeline import ServingPipeline as TPipeline

LAM_RTOL = 1e-3


def _both(build):
    """The same spec built from both packages' axis classes."""
    return build(jspec), build(tspec)


# ---------------------------------------------------------------------------
# Validation and the compiled structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,exc,match", [
    (lambda s: s.TenantAxis(()), ValueError, "at least one budget"),
    (lambda s: s.TenantAxis((1.0, -2.0)), ValueError, "positive"),
    (lambda s: s.RegionAxis(1), ValueError, ">= 2"),
    (lambda s: s.RegionAxis(2, split="dither"), ValueError, "split"),
    (lambda s: s.RegionAxis(2, tie_tol=1.0), ValueError, "tie_tol"),
    (lambda s: s.RegionAxis(2, names=("only_one",)), ValueError, "names"),
    (lambda s: s.GlobalAxis(budget=1.0, pricing="joules"), ValueError,
     "pricing"),
    (lambda s: s.GlobalAxis(budget=0.0), ValueError, "positive"),
    (lambda s: s.ConstraintSpec([s.TenantAxis((1.0,)),
                                 s.TenantAxis((2.0,))]).compile(),
     ValueError, "duplicate TenantAxis"),
    (lambda s: s.ConstraintSpec([s.RegionAxis(2)]).compile(), ValueError,
     "budget source"),
    (lambda s: s.ConstraintSpec(["tenants"]).compile(), TypeError,
     "unknown constraint axis"),
    (lambda s: s.spec_from_legacy(1.0, tenant_budgets=[1.0],
                                  tenant_mode="vip"), ValueError,
     "tenant_mode"),
])
def test_validation_matches_jax(make, exc, match):
    for mod in (jspec, tspec):
        with pytest.raises(exc, match=match):
            make(mod)


SPECS = {
    "plain": lambda s: s.ConstraintSpec([s.GlobalAxis(budget=100.0)]),
    "legacy_plain": lambda s: s.spec_from_legacy(100.0),
    "legacy_tenants": lambda s: s.spec_from_legacy(
        100.0, tenant_budgets=[30.0, 70.0]),
    "legacy_priced": lambda s: s.spec_from_legacy(
        100.0, tenant_budgets=[30.0, 70.0], tenant_mode="priced"),
    "legacy_geo": lambda s: s.spec_from_legacy(100.0, n_regions=2),
    "geo_named": lambda s: s.ConstraintSpec([
        s.RegionAxis(3, names=("a", "b", "c"), tie_tol=0.1),
        s.GlobalAxis(budget=5.0, pricing="carbon")]),
    "geotenants": lambda s: s.ConstraintSpec([
        s.TenantAxis((30.0, 70.0), priced=True), s.RegionAxis(2),
        s.GlobalAxis(pricing="carbon")]),
    "geotenants_shared": lambda s: s.ConstraintSpec([
        s.TenantAxis((30.0, 70.0, 10.0)),
        s.RegionAxis(2, split="argmax")]),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_compiled_structure_matches_jax(name):
    j, t = _both(lambda s: SPECS[name](s).compile())
    for attr in ("mode", "n_prices", "k_names", "budget_names",
                 "scale_names", "total_budget", "pricing", "split",
                 "tie_tol", "t_n", "r_n", "tenant_priced"):
        assert getattr(t, attr) == getattr(j, attr), (name, attr)
    assert t.budget_len() == j.budget_len()


@pytest.mark.parametrize("name", ["geotenants", "geotenants_shared",
                                  "geo_named", "legacy_priced"])
def test_constructors_match_jax(name):
    j, t = _both(lambda s: SPECS[name](s).compile())
    rng = np.random.default_rng(3)
    j_n = 5
    r_n = j.r_n or 1
    opt = (rng.integers(1, 50, j_n * r_n) * 4.0).astype(np.float32)
    k_of = rng.integers(0, j.t_n or 1, 11).astype(np.int32)
    to_np = np.asarray
    if j.regions is not None:
        np.testing.assert_array_equal(
            t.region_cost_map(torch.tensor(opt), j_n).numpy(),
            to_np(j.region_cost_map(opt, j_n)))
    np.testing.assert_array_equal(
        t.dual_cost_map(torch.tensor(opt), j_n).numpy(),
        to_np(j.dual_cost_map(opt, j_n)))
    if j.tenants is not None:
        np.testing.assert_array_equal(
            t.tenant_member(torch.tensor(k_of).long()).numpy(),
            to_np(j.tenant_member(k_of)))
    jm = j.dual_member(k_of, 11)
    tm = t.dual_member(torch.tensor(k_of).long(), 11)
    assert (jm is None) == (tm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm.numpy(), to_np(jm))


# ---------------------------------------------------------------------------
# Every mode against the JAX pipeline, at the JAX prices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    return torch_tiny.build(pow2=True)


def _plan(stack, name):
    """(spec factory, per-window (n, budget, cost_scale)) of a mode."""
    c_max = float(stack.jchains.costs.max())
    per = 32
    tb = tuple(c_max * per * f for f in (0.25, 0.5, 1.5))
    if name == "plain":
        b = 0.5 * c_max * 64
        return (lambda s: s.ConstraintSpec([s.GlobalAxis(budget=b)]),
                [(64, None, None), (60, 0.3 * b, 0.5), (64, b, 2.0),
                 (50, None, None)])
    if name.startswith("tenants"):
        priced = name == "tenants_priced"
        return (lambda s: s.ConstraintSpec(
            [s.TenantAxis(tb[:2], priced=priced),
             s.GlobalAxis(budget=sum(tb[:2]))]),
                [(64, None, None), (60, np.array(tb[1:]), 0.5),
                 (64, np.array(tb[:2]) * 2, 1.0), (62, None, 2.0)])
    r_b = 0.3 * c_max * 64
    if name.startswith("geo_"):
        split = name[4:]
        return (lambda s: s.ConstraintSpec(
            [s.RegionAxis(2, split=split), s.GlobalAxis(budget=2 * r_b)]),
                [(64, np.array([r_b, r_b]), np.array([1.0, 1.0])),
                 (60, np.array([2 * r_b, r_b]), np.array([1.0, 0.5])),
                 (64, np.array([r_b, 0.5 * r_b]), np.array([0.5, 1.0])),
                 (64, np.array([r_b, 3 * r_b]), np.array([2.0, 2.0]))])
    priced = name != "geotenants_shared"
    split = "argmax" if name == "geotenants_argmax" else "flow"
    rg = 0.4 * sum(tb)
    return (lambda s: s.ConstraintSpec(
        [s.TenantAxis(tb, priced=priced), s.RegionAxis(2, split=split),
         s.GlobalAxis(pricing="carbon")]),
            [(96, np.array([*tb, rg, rg]), np.array([1.0, 1.0])),
             (90, np.array([*tb, rg, 0.5 * rg]), np.array([1.0, 0.5])),
             (96, np.array([*tb, 2 * rg, rg]), np.array([2.0, 1.0])),
             (96, np.array([*tb, rg, rg]), np.array([0.5, 0.5]))])


MODES = ["plain", "tenants_shared", "tenants_priced", "geo_flow",
         "geo_argmax", "geotenants_priced", "geotenants_shared",
         "geotenants_argmax"]


def _kw(budget, scale):
    return {k: v for k, v in (("budget", budget), ("cost_scale", scale))
            if v is not None}


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_at_pinned_prices(stack, mode):
    make, plan = _plan(stack, mode)
    jspec_, tspec_ = _both(make)
    jpipe = JPipeline.from_spec(stack.jserver, stack.jparams, stack.jrcfg,
                                jspec_)
    tpipe = torch_tiny.FedPipeline.from_spec(stack, tspec_)
    wins = torch_tiny.windows(len(plan), n=max(p[0] for p in plan), seed=21)
    downgraded = 0
    for t, ((n, budget, scale), (ctx, rows)) in enumerate(zip(plan, wins)):
        ctx, rows = ctx[:n], rows[:n]
        lam = np.asarray(jpipe.lam)  # the JAX package's entry price
        jr = jpipe.serve_window(ctx, rows, **_kw(budget, scale))
        tr = tpipe.serve_window(ctx, rows, lam=lam, **_kw(budget, scale))
        assert tr.bucket[:2] == jr.bucket[:2], (mode, t)
        np.testing.assert_array_equal(tr.valid, jr.valid)
        np.testing.assert_array_equal(tr.decisions_np, jr.decisions_np)
        np.testing.assert_array_equal(tr.revenue_np, jr.revenue_np)
        assert int(tr.downgraded) == int(jr.downgraded), (mode, t)
        for name in ("spend", "flops", "tenant_spend", "region_spend",
                     "tr_spend"):
            got, want = getattr(tr, name), getattr(jr, name)
            assert (got is None) == (want is None), (mode, name)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{mode} {t} {name}")
        if jr.regions is not None:
            np.testing.assert_array_equal(tr.regions_np, jr.regions_np)
        np.testing.assert_array_equal(tr.lam_before.numpy(), lam)
        np.testing.assert_allclose(tr.lam_after.numpy(),
                                   np.asarray(jr.lam_after), rtol=LAM_RTOL,
                                   atol=1e-12)
        assert tr.budget == pytest.approx(jr.budget, rel=1e-6)
        downgraded += int(tr.downgraded)
    assert downgraded > 0, mode  # the guard acted somewhere in the day
    assert float(np.max(np.asarray(jpipe.lam))) > 0  # the price moved


def test_flow_split_divides_tied_window(stack):
    """Equal scales (an exact tie): the flow split hands each region a
    FLOPs share proportional to its budget, and the JAX package splits
    the same requests the same way (part of the exact mode test above);
    here the proportions themselves."""
    make, _ = _plan(stack, "geo_flow")
    pipe = torch_tiny.FedPipeline.from_spec(stack, make(tspec))
    r_b = 1e12  # slack: nothing downgrades, the split alone decides
    ctx, rows = torch_tiny.windows(1, seed=12)[0]
    res = pipe.serve_window(ctx, rows, lam=0.0,
                            budget=np.array([3 * r_b, r_b]),
                            cost_scale=np.array([1.0, 1.0]))
    flops = stack.tchains.costs[res.decisions_np]
    frac0 = flops[res.regions_np == 0].sum() / flops.sum()
    assert abs(frac0 - 0.75) <= float(flops.max() / flops.sum())
    assert int(res.downgraded) == 0


# ---------------------------------------------------------------------------
# Per-window numbers are program inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "tenants_priced",
                                  "geotenants_priced"])
def test_window_numbers_are_program_inputs(stack, mode):
    """Window B served after window A on one bucket (other budgets,
    scales and dual targets) equals window B served first on a fresh
    pipeline: nothing of A's numbers stays in the bucket's program."""
    make, plan = _plan(stack, mode)
    (n, bud_a, sc_a), (_, bud_b, sc_b) = plan[0], plan[2]
    wins = torch_tiny.windows(2, n=n, seed=31)
    spec = make(tspec)
    warm = torch_tiny.FedPipeline.from_spec(stack, spec)
    warm.serve_window(*wins[0], **_kw(bud_a, sc_a))
    kw_b = dict(_kw(bud_b, sc_b), dual_budget=bud_a, dual_cost_scale=sc_a)
    lam = warm.lam.clone()
    got = warm.serve_window(*wins[1], lam=lam, **kw_b)
    assert got.compiles == 0
    fresh = torch_tiny.FedPipeline.from_spec(stack, spec)
    want = fresh.serve_window(*wins[1], lam=lam, **kw_b)
    assert want.compiles == 2
    for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                 "lam_before", "lam_after", "tenant_spend", "tr_spend",
                 "regions"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), (mode, name)
    assert not torch.equal(got.lam_after, warm.stats[0].lam_after)


def test_named_budgets_equal_positional(stack):
    make, plan = _plan(stack, "geotenants_priced")
    spec = make(tspec)
    names, snames = spec.compile().budget_names, spec.compile().scale_names
    n, bud, sc = plan[1]
    ctx, rows = torch_tiny.windows(1, n=n, seed=41)[0]
    runs = []
    for kw in (dict(budget=bud, cost_scale=sc),
               dict(budget=dict(zip(names, bud)),
                    cost_scale=dict(zip(snames, sc)))):
        pipe = torch_tiny.FedPipeline.from_spec(stack, spec)
        runs.append(pipe.serve_window(ctx, rows, **kw))
    for name in ("decisions", "spend", "tr_spend", "lam_after"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    pipe = torch_tiny.FedPipeline.from_spec(stack, spec)
    with pytest.raises(ValueError, match="named budget keys"):
        pipe.serve_window(ctx, rows, budget={"tenant[0]": 1.0},
                          cost_scale=sc)
    with pytest.raises(ValueError, match="per-region budgets"):
        pipe.serve_window(ctx, rows, budget=bud)


# ops that read a device value on the host (or branch on it) and so
# synchronise with the card
_SYNCING = {"_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal"}


class _SyncWatch(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.syncing: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func.overloadpacket.__name__ in _SYNCING:
            self.syncing.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", MODES)
def test_window_programs_never_synchronise(stack, mode):
    """Each mode's window program (main pass and dual loop, which the
    card captures as CUDA graphs) runs no op that makes the host wait
    for the device."""
    make, plan = _plan(stack, mode)
    pipe = TPipeline.from_spec(stack.tserver, stack.tparams, stack.trcfg,
                               make(tspec), device="cpu")
    n, budget, scale = plan[1]
    ctx, rows = torch_tiny.windows(1, n=n, seed=51)[0]
    pipe.serve_window(ctx, rows, **_kw(budget, scale))
    for key, prog in pipe._programs.items():
        for name in ("main", "dual"):
            with _SyncWatch() as watch:
                getattr(prog, name).fn()
            assert watch.ops > 10, (key, name)
            assert not watch.syncing, (mode, name, watch.syncing)
