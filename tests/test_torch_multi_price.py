"""The port's multi-price allocator core against the JAX package's.

  * K = 1: the port's vector path (a (J, 1) cost map, a (1,) price,
    ``k_of`` all zeros) reproduces its own scalar path bit for bit -
    decisions, consumption, the dual price and its gap trace, the guard;
  * K > 1: Eq. 10 decisions at pinned prices, per-constraint
    consumption, the per-constraint guard and the chained tenant/region
    guard equal the JAX package's EXACTLY - the costs are integers, so
    every f32 sum is exact in any order; and the port's per-constraint
    walk equals per-block scalar walks bit for bit;
  * the (K,) dual descent, the scalar bisection oracle and the host
    window step agree with the JAX package within 1e-3 relative (each
    step sums in another order; the bisection is exact);
  * a priced single tenant serves exactly as the plain pipeline, and the
    CI-forecast warm start is a bitwise no-op on constant traces and
    matches the JAX package's forecast on a stepped one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tiny

from repro.core import primal_dual as jpd
from repro.serving import guard as jguard
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.stream import run_stream as jrun_stream
from repro_torch.core import primal_dual as tpd
from repro_torch.serving import guard as tguard
from repro_torch.serving import spec as tspec
from repro_torch.serving.pipeline import ServingPipeline as TPipeline
from repro_torch.serving.stream import run_stream as trun_stream

LAM_RTOL = 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# K = 1: the vector path is the scalar path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_k1_vector_path_bitwise_scalar(seed):
    rng = np.random.default_rng(seed)
    i, j = 96, 12
    for trial in range(5):
        R = torch.tensor(rng.uniform(0, 5, (i, j)), dtype=torch.float32)
        c = torch.tensor(rng.uniform(1, 10, j), dtype=torch.float32)
        lam = torch.tensor(rng.uniform(0, 1), dtype=torch.float32)
        mask = torch.tensor((rng.random(i) < 0.8).astype(np.float32))
        cv, lv = c[:, None], lam[None]
        assert torch.equal(tpd.allocate(R, c, lam), tpd.allocate(R, cv, lv))
        u_s = tpd.consumption(R, c, lam, mask)
        u_v = tpd.consumption(R, cv, lv, mask)
        assert torch.equal(u_s[None], u_v), trial
        budget = 0.5 * float(u_s)
        l_s, g_s = tpd.dual_descent(R, c, budget, lam, mask=mask)
        l_v, g_v = tpd.dual_descent(R, cv, torch.tensor([budget]), lv,
                                    mask=mask)
        assert torch.equal(l_s[None], l_v), trial
        assert torch.equal(g_s, g_v[:, 0]), trial
        dec = torch.tensor(rng.integers(0, j, i), dtype=torch.int32)
        cheap = int(torch.argmin(c))
        bud = float(rng.uniform(0.3, 1.1)) * float(torch.sum(c[dec.long()]
                                                             * mask))
        d_s, k_s, s_s = tguard.downgrade_guard(dec, c, bud, cheap, mask)
        d_v, k_v, s_v = tguard.downgrade_guard(
            dec, c, torch.tensor([bud]), cheap, mask,
            k_of=torch.zeros(i, dtype=torch.int64))
        assert torch.equal(d_s, d_v) and torch.equal(k_s, k_v)
        assert torch.equal(s_s[None], s_v), trial


# ---------------------------------------------------------------------------
# K > 1 at the core, exact against the JAX package
# ---------------------------------------------------------------------------


def _tenant_region_instance(seed, i=48, j=5, t_n=2, r_n=2):
    """K = T*R: option m = r*J + j draws c_{j,r} from every (t, r)
    column; request i is a member of its tenant's columns.  Integer
    costs keep every f32 sum exact."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 40, j).astype(np.float64)
    region_scale = np.array([1.0, 2.0, 0.5, 4.0])[:r_n]
    rewards = np.tile(rng.uniform(0, 5, (i, j)), (1, r_n)).astype(
        np.float32)
    k_n = t_n * r_n
    cost_map = np.zeros((j * r_n, k_n), np.float32)
    for r in range(r_n):
        for t in range(t_n):
            cost_map[r * j:(r + 1) * j, t * r_n + r] = base * \
                region_scale[r]
    tenant = rng.integers(0, t_n, i)
    member = np.zeros((i, k_n), np.float32)
    for r in range(r_n):
        member[np.arange(i), tenant * r_n + r] = 1.0
    lam = (rng.uniform(0, 0.5, k_n) / base.mean()).astype(np.float32)
    return rewards, cost_map, member, lam, tenant


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_member", [True, False])
def test_k_allocate_and_consumption_exact(seed, with_member):
    rewards, cm, member, lam, _ = _tenant_region_instance(seed)
    if not with_member:  # a geo map: option m draws from its region only
        cm = cm[:, :2]
        lam = lam[:2]
    mem_j = jnp.asarray(member) if with_member else None
    mem_t = _t(member) if with_member else None
    mask = (np.random.default_rng(seed).random(len(rewards)) < 0.8
            ).astype(np.float32)
    want = np.asarray(jpd.allocate(jnp.asarray(rewards), jnp.asarray(cm),
                                   jnp.asarray(lam), mem_j))
    got = tpd.allocate(_t(rewards), _t(cm), _t(lam), mem_t).numpy()
    np.testing.assert_array_equal(got, want)
    used_j = jpd.consumption(jnp.asarray(rewards), jnp.asarray(cm),
                             jnp.asarray(lam), jnp.asarray(mask),
                             member=mem_j)
    used_t = tpd.consumption(_t(rewards), _t(cm), _t(lam), _t(mask),
                             member=mem_t)
    np.testing.assert_array_equal(used_t.numpy(), np.asarray(used_j))


def test_realized_reward_matches_jax():
    rng = np.random.default_rng(2)
    rewards = rng.integers(0, 50, (40, 7)).astype(np.float32)
    dec = rng.integers(0, 7, 40).astype(np.int32)
    assert float(tpd.realized_reward(_t(rewards), _t(dec))) == float(
        jpd.realized_reward(jnp.asarray(rewards), jnp.asarray(dec)))


def test_vector_price_without_member_needs_full_map():
    with pytest.raises(ValueError, match="member"):
        tpd.allocate(torch.zeros(3, 4), torch.ones(4, 1), torch.zeros(2))


def _guard_case(seed, t_n=3, per=40, j=8):
    rng = np.random.default_rng(seed)
    costs = (16.0 * rng.integers(1, 64, j)).astype(np.float32)
    dec = rng.integers(0, j, t_n * per).astype(np.int32)
    valid = (rng.random(t_n * per) < 0.9).astype(np.float32)
    k_of = np.repeat(np.arange(t_n, dtype=np.int32), per)
    spend = np.array([(costs[dec] * valid)[k_of == k].sum()
                      for k in range(t_n)])
    budgets = (rng.uniform(0.3, 1.1, t_n) * spend).astype(np.float32)
    return costs, dec, valid, k_of, budgets


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("per_k_cheap", [False, True])
def test_k_guard_exact_and_per_block(seed, per_k_cheap):
    costs, dec, valid, k_of, budgets = _guard_case(seed)
    t_n, per = len(budgets), len(dec) // len(budgets)
    cheap = int(np.argmin(costs))
    if per_k_cheap:
        cheap = np.argsort(costs)[:t_n].astype(np.int32)
    jd, jk, js = jguard.downgrade_guard(
        jnp.asarray(dec), jnp.asarray(costs), jnp.asarray(budgets),
        jnp.asarray(cheap), jnp.asarray(valid), k_of=jnp.asarray(k_of))
    td, tk, ts = tguard.downgrade_guard(
        _t(dec), _t(costs), _t(budgets), _t(cheap), _t(valid),
        k_of=_t(k_of))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tk) == int(jk) > 0
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's per-constraint walk == its scalar walk block by block
    for k in range(t_n):
        blk = slice(k * per, (k + 1) * per)
        ck = int(cheap[k]) if per_k_cheap else cheap
        bd, _, bs = tguard.downgrade_guard(
            _t(dec[blk]), _t(costs), float(budgets[k]), ck, _t(valid[blk]))
        assert torch.equal(bd, td[blk]) and torch.equal(bs, ts[k]), k


@pytest.mark.parametrize("seed", range(4))
def test_guard_chain_exact(seed):
    """Tenant walk (one cheapest option) then region walk (each
    region's cheapest option, membership following the decisions)."""
    rng = np.random.default_rng(seed)
    j_n, r_n, t_n, per = 6, 2, 3, 32
    base = (16.0 * rng.integers(1, 64, j_n)).astype(np.float32)
    opt = np.concatenate([base, 0.5 * base]).astype(np.float32)
    dec = rng.integers(0, j_n * r_n, t_n * per).astype(np.int32)
    valid = (rng.random(t_n * per) < 0.9).astype(np.float32)
    k_of = np.repeat(np.arange(t_n, dtype=np.int32), per)
    cd = opt[dec] * valid
    tb = np.array([0.6 * cd[k_of == t].sum() for t in range(t_n)],
                  np.float32)
    rb = np.array([0.7 * cd[dec // j_n == r].sum() for r in range(r_n)],
                  np.float32)
    cheap = int(np.argmin(base))
    cheap_m, cheap_k = int(np.argmin(opt)), np.arange(r_n) * j_n + cheap
    jd, jk, js = jguard.downgrade_guard_chain(
        jnp.asarray(dec), jnp.asarray(opt),
        [(jnp.asarray(tb), cheap_m, jnp.asarray(k_of)),
         (jnp.asarray(rb), jnp.asarray(cheap_k), lambda d: d // j_n)],
        jnp.asarray(valid))
    td, tk, ts = tguard.downgrade_guard_chain(
        _t(dec), _t(opt),
        [(_t(tb), cheap_m, _t(k_of)),
         (_t(rb), _t(cheap_k), lambda d: d.long() // j_n)], _t(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tk) == int(jk) > 0
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Dual prices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_k_dual_descent_matches_jax(seed):
    rewards, cm, member, _, _ = _tenant_region_instance(seed, i=96)
    k_n = cm.shape[1]
    free = np.asarray(jpd.consumption(
        jnp.asarray(rewards), jnp.asarray(cm), jnp.zeros(k_n),
        member=jnp.asarray(member)))
    budgets = (0.6 * free).astype(np.float32)
    kw = dict(max_iters=300, step_size=2.0)
    lam_j, gaps_j = jpd.dual_descent(
        jnp.asarray(rewards), jnp.asarray(cm), jnp.asarray(budgets),
        jnp.zeros(k_n, jnp.float32), member=jnp.asarray(member), **kw)
    lam_t, gaps_t = tpd.dual_descent(
        _t(rewards), _t(cm), _t(budgets), torch.zeros(k_n),
        member=_t(member), **kw)
    assert np.all(np.asarray(lam_j)[free > 0] > 0)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j),
                               rtol=LAM_RTOL)
    np.testing.assert_allclose(gaps_t.numpy(), np.asarray(gaps_j),
                               rtol=LAM_RTOL, atol=1e-3 * budgets.max())


@pytest.mark.parametrize("seed,frac", [(0, 0.3), (1, 0.6), (2, 0.95),
                                       (3, 5.0)])
def test_dual_bisect_matches_jax(seed, frac):
    rng = np.random.default_rng(seed)
    rewards = rng.uniform(0, 5, (80, 10)).astype(np.float32)
    costs = (8.0 * rng.integers(1, 100, 10)).astype(np.float32)
    budget = frac * float(costs.mean()) * 80 * 0.5
    want = float(jpd.dual_bisect(jnp.asarray(rewards), jnp.asarray(costs),
                                 budget))
    got = float(tpd.dual_bisect(_t(rewards), _t(costs), budget))
    assert got == want
    assert (got == 0.0) == (frac >= 5.0)


def test_window_step_and_tracker_match_jax():
    rng = np.random.default_rng(7)
    costs = (16.0 * rng.integers(1, 200, 12)).astype(np.float32)
    cheap = int(np.argmin(costs))
    budget = 0.4 * float(costs.max()) * 64
    jlam, tlam = jnp.float32(0.0), torch.tensor(0.0)
    jtr = jpd.DynamicPrimalDual(costs, budget)
    ttr = tpd.DynamicPrimalDual(costs, budget)
    for _ in range(4):
        rewards = rng.gamma(2.0, 1.0, (64, 12)).astype(np.float32)
        jd, jdg, jsp, jlam = jpd.window_step(rewards, costs, budget, jlam,
                                             cheap=cheap)
        td, tdg, tsp, tlam = tpd.window_step(rewards, costs, budget, tlam,
                                             cheap=cheap)
        np.testing.assert_array_equal(td, jd)
        assert (tdg, tsp) == (jdg, jsp)
        np.testing.assert_allclose(float(tlam), float(jlam), rtol=LAM_RTOL)
        tlam = torch.tensor(float(jlam))  # pin the next window's entry
        np.testing.assert_array_equal(ttr.decide(rewards).numpy(),
                                      np.asarray(jtr.decide(rewards)))
        np.testing.assert_allclose(ttr.update(rewards), jtr.update(rewards),
                                   rtol=LAM_RTOL)
        ttr.lam = torch.tensor(float(jtr.lam))


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    return torch_tiny.build(pow2=True)


def test_priced_single_tenant_is_plain(stack):
    """T = 1 priced tenants is the K = 1 case of the window program."""
    budget = 0.5 * float(stack.tchains.costs.max()) * 64
    plain = TPipeline(stack.tserver, stack.tparams, stack.trcfg, budget,
                      device="cpu")
    priced = TPipeline(stack.tserver, stack.tparams, stack.trcfg, budget,
                       tenant_budgets=[budget], tenant_mode="priced",
                       device="cpu")
    for ctx, rows in torch_tiny.windows(4):
        a, b = plain.serve_window(ctx, rows), priced.serve_window(ctx, rows)
        for name in ("decisions", "revenue", "downgraded", "spend",
                     "flops"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert torch.equal(a.lam_after[None], b.lam_after)
    assert float(plain.lam) > 0
    np.testing.assert_array_equal(plain.spend_trace(), priced.spend_trace())


def _stepped_day(stack, n_w=6, b=64):
    c_max = float(stack.tchains.costs.max())
    scales = np.array([1.0] * (n_w // 2) + [2.0] * (n_w // 2))
    grams = np.full(n_w, 0.4 * c_max * b)
    wins = torch_tiny.windows(n_w, n=b, seed=9)
    return [b] * n_w, grams, scales, (lambda t, n: wins[t])


def test_forecast_noop_on_constant_traces(stack):
    sizes, grams, _, sample = _stepped_day(stack)
    runs = []
    for forecast in (False, True):
        pipe = TPipeline(stack.tserver, stack.tparams, stack.trcfg,
                         float(grams[0]), device="cpu")
        runs.append(trun_stream(pipe, sizes, sample, budget_trace=grams,
                                scale_trace=np.ones(len(sizes)),
                                forecast=forecast, prefetch=0))
    for a, b in zip(*(r.windows for r in runs)):
        assert torch.equal(a.decisions, b.decisions)
        assert torch.equal(a.lam_after, b.lam_after)


@pytest.mark.parametrize("mode", ["plain", "geo"])
def test_forecast_matches_jax(stack, mode):
    """A stepped cost scale with the forecast warm start: at the JAX
    run's entry prices the port's decisions are exact and its forecast
    prices agree within 1e-3."""
    sizes, grams, scales, sample = _stepped_day(stack)
    if mode == "plain":
        spec = tspec.ConstraintSpec([tspec.GlobalAxis(float(grams[0]))])
        budgets, scale_tr = grams, scales
        jkw = {}
    else:
        spec = tspec.ConstraintSpec([tspec.RegionAxis(2),
                                     tspec.GlobalAxis(float(grams[0]))])
        budgets = np.stack([grams, 0.5 * grams], axis=1)
        scale_tr = np.stack([scales, scales[::-1]], axis=1)
        from repro.serving import spec as jspec
        jkw = dict(spec=jspec.ConstraintSpec([jspec.RegionAxis(2),
                                              jspec.GlobalAxis(
                                                  float(grams[0]))]))
    jpipe = JPipeline(stack.jserver, stack.jparams, stack.jrcfg,
                      float(grams[0]), **jkw)
    jst = jrun_stream(jpipe, sizes, sample, budget_trace=budgets,
                      scale_trace=scale_tr, forecast=True, prefetch=0)
    tpipe = torch_tiny.FedPipeline.from_spec(stack, spec)
    lam_trace = [np.asarray(w.lam_before) for w in jst.windows]
    tst = trun_stream(tpipe, sizes, sample, lam_trace=lam_trace,
                      budget_trace=budgets, scale_trace=scale_tr,
                      forecast=True, prefetch=0)
    for jw, tw in zip(jst.windows, tst.windows):
        np.testing.assert_array_equal(tw.decisions_np, jw.decisions_np)
        np.testing.assert_allclose(tw.lam_after.numpy(),
                                   np.asarray(jw.lam_after), rtol=LAM_RTOL)
    assert tst.total_spend == pytest.approx(jst.total_spend, rel=1e-6)
