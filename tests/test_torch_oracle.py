"""The port's cascade oracle, budget controller, PFEC accounting and
baselines against the JAX package's, and ``CascadeServer.serve``.

Exact throughout: revenue counts 0/1 clicks, the chain arithmetic is
integer, and the baselines' choices are argmaxes on identical inputs
(CRAS's bisection and the controller's decisions are exact on the same
rewards; its price within 1e-3 relative, summed in another order).
``CascadeServer.serve`` on the CPU runs the truncation kernel's plain
version wherever the layout has a compact plan, and is held to the
generic per-request oracle ``_revenue_requests``.  The controller's
test asserts the cap and pins the price at 0 where it needs downgrades
(the entry price of a spike window already sends every request to the
cheapest chain, so a free-running price may leave nothing to
downgrade).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tiny

from repro.cascade import engine as jeng
from repro.core import action_chain as jac
from repro.core import allocator as jalloc
from repro.core import baselines as jbase
from repro.core import budget as jbudget
from repro.core import pfec as jpfec
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac
from repro_torch.core import allocator as talloc
from repro_torch.core import baselines as tbase
from repro_torch.core import budget as tbudget
from repro_torch.core import pfec as tpfec
from repro_torch.kernels import ops
from repro_torch.serving import spec as tspec

MODELS = ("DSSM", "YDNN", "DIN", "DIEN")


def _world(u, i, seed, *, ties=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if ties:  # coarse integer scores: plenty of exact ties
        scores = {k: rng.integers(0, 5, size=(u, i)).astype(dtype)
                  for k in MODELS}
    else:
        scores = {k: rng.normal(size=(u, i)).astype(dtype) for k in MODELS}
    clicks = (rng.random((u, i)) < 0.15).astype(np.float32)
    return scores, clicks


def _generic_chains(ac, i):
    """Two recall models: off the compact (k3) layout."""
    return ac.generate_action_chains((
        ac.StageSpec("recall", (ac.ModelInstance("DSSM", 16.0),
                                ac.ModelInstance("YDNN", 64.0)), (i,), 4),
        ac.StageSpec("prerank", (ac.ModelInstance("YDNN", 64.0),),
                     (40, 60), 4),
        ac.StageSpec("rank", (ac.ModelInstance("DIN", 512.0),
                              ac.ModelInstance("DIEN", 1024.0)), (10, 20),
                     4)))


@pytest.mark.parametrize("desc", [(150, 50, 20, "DIN"), (150, 30, 30, "DIEN"),
                                  (150, 20, 60, "DIN"), (150, 1, 1, "DIEN"),
                                  (120, 50, 20, "DIN")])
def test_run_chain_matches_jax(desc):
    scores, clicks = _world(8, 150, 0, ties=True)
    np.testing.assert_array_equal(
        teng.run_chain(scores, desc, clicks, expose=8),
        jeng.run_chain(scores, desc, clicks, expose=8))


@pytest.mark.parametrize("seed,ties,dtype", [
    (3, False, np.float64), (4, False, np.float32),
    (5, True, np.float64), (6, True, np.float32)])
def test_revenue_matrix_matches_jax(seed, ties, dtype):
    scores, clicks = _world(24, 150, seed, ties=ties, dtype=dtype)
    jc = torch_tiny.chains(jac, torch_tiny.POW2_FLOPS)
    tc = torch_tiny.chains(tac, torch_tiny.POW2_FLOPS)
    want = jeng.simulate_revenue_matrix(scores, jc, clicks, expose=8)
    got = teng.simulate_revenue_matrix(scores, tc, clicks, expose=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        teng.simulate_revenue_matrix_reference(scores, tc, clicks, expose=8),
        want)
    # the generic scan form on tensors, on the same chains
    ranked = teng.rank_stage_scores(scores)
    slots, keeps = teng.chain_plan(tc, ranked.slot, expose=8, n_items=150)
    scan = teng._revenue_all_chains(
        torch.from_numpy(ranked.orders), torch.from_numpy(ranked.ranks),
        torch.from_numpy(clicks), torch.from_numpy(slots),
        torch.from_numpy(keeps), n_stages=3)
    np.testing.assert_array_equal(scan.numpy(), want)


def test_generic_layout_matches_jax():
    """Off the k3 layout both packages run the generic scan."""
    scores, clicks = _world(12, 100, 2)
    jc, tc = _generic_chains(jac, 100), _generic_chains(tac, 100)
    assert teng._k3_layout(tc, n_items=100) is None
    np.testing.assert_array_equal(
        teng.simulate_revenue_matrix(scores, tc, clicks, expose=8),
        jeng.simulate_revenue_matrix(scores, jc, clicks, expose=8))


@pytest.fixture(scope="module")
def stack():
    return torch_tiny.build(pow2=True)


def test_compact_plan_matches_jax(stack):
    j, t = stack.jserver.compact, stack.tserver.compact
    for name in ("p_sorted", "clicks_sorted", "group_of_chain",
                 "n3_of_chain"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.cap, t.expose) == (j.cap, j.expose)


@pytest.mark.parametrize("seed", range(3))
def test_server_serve_matches_oracle(stack, seed):
    """``serve`` (the truncation kernel's plain version on the CPU) ==
    the generic per-request oracle == the JAX server == the matrix."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, torch_tiny.U, 96)
    dec = rng.integers(0, stack.tchains.n_chains, 96)
    before = dict(ops.LAUNCHES)
    rev, flops = stack.tserver.serve(rows, dec)
    assert ops.LAUNCHES == before  # the CPU counts no kernel launch
    srv = stack.tserver
    r = srv._ranked
    oracle = teng._revenue_requests(
        torch.from_numpy(r.orders), torch.from_numpy(r.ranks),
        torch.from_numpy(stack.clicks), torch.from_numpy(srv._slots[dec]),
        torch.from_numpy(srv._keeps[dec]), torch.from_numpy(rows),
        n_stages=3)
    np.testing.assert_array_equal(rev, oracle.numpy())
    jrev, jflops = stack.jserver.serve(rows, dec)
    np.testing.assert_array_equal(rev, np.asarray(jrev))
    np.testing.assert_array_equal(flops, jflops)
    mat = teng.simulate_revenue_matrix(stack.scores, stack.tchains,
                                       stack.clicks, expose=8)
    np.testing.assert_array_equal(rev, mat[rows, dec])


def test_generic_server_runs_the_oracle():
    scores, clicks = _world(10, 100, 4)
    tc, jc = _generic_chains(tac, 100), _generic_chains(jac, 100)
    srv = teng.CascadeServer(scores, tc, clicks, expose=8, device="cpu")
    assert srv.compact is None and srv.tables is None
    rng = np.random.default_rng(1)
    rows, dec = rng.integers(0, 10, 40), rng.integers(0, tc.n_chains, 40)
    jsrv = jeng.CascadeServer(stage_scores=scores, chains=jc, clicks=clicks,
                              expose=8)
    np.testing.assert_array_equal(srv.serve(rows, dec)[0],
                                  np.asarray(jsrv.serve(rows, dec)[0]))


# ---------------------------------------------------------------------------
# Baselines, controller, PFEC, the allocator facade
# ---------------------------------------------------------------------------

PAPER = (jac.generate_action_chains(jac.paper_stage_specs()),
         tac.generate_action_chains(tac.paper_stage_specs()))


@pytest.mark.parametrize("frac,rank_model", [
    (0.5, None), (1.0, None), (3.0, None), (1e-9, None), (1.0, "DIN"),
    (10.0, "DIEN")])
def test_equal_allocation_matches_jax(frac, rank_model):
    jc, tc = PAPER
    budget = frac * float(np.median(jc.costs)) * 100
    assert tbase.equal_allocation(tc, budget, 100, rank_model=rank_model) \
        == jbase.equal_allocation(jc, budget, 100, rank_model=rank_model)


@pytest.mark.parametrize("seed,frac,rank_model", [
    (0, 1.0, None), (1, 0.4, None), (2, 3.0, "DIN"), (3, 0.8, "DIEN")])
def test_cras_allocation_matches_jax(seed, frac, rank_model):
    jc, tc = PAPER
    rng = np.random.default_rng(seed)
    n = 60
    jsp = [jbase.StageActionSpace.from_chains(jc, k) for k in range(3)]
    tsp = [tbase.StageActionSpace.from_chains(tc, k) for k in range(3)]
    for a, b in zip(jsp, tsp):
        np.testing.assert_array_equal(a.actions, b.actions)
        np.testing.assert_array_equal(a.costs, b.costs)
    rewards = [rng.uniform(0, 1, (n, len(sp.costs))).astype(np.float32)
               for sp in jsp]
    budget = frac * float(np.median(jc.costs)) * n
    want = jbase.cras_allocation([jnp.asarray(r) for r in rewards], jsp, jc,
                                 budget, rank_model=rank_model)
    got = tbase.cras_allocation([torch.from_numpy(r) for r in rewards], tsp,
                                tc, budget, rank_model=rank_model)
    np.testing.assert_array_equal(got, want)


def test_budget_controller_matches_jax_and_caps_spend():
    jc, tc = PAPER
    rng = np.random.default_rng(0)
    n = 200
    budget = float(np.median(tc.costs)) * n * 0.7
    jctl, tctl = jbudget.BudgetController(jc, budget), \
        tbudget.BudgetController(tc, budget)
    rewards = np.tile(tc.costs / tc.costs.max(), (n, 1)).astype(np.float32)
    for _ in range(3):
        r = (rewards + rng.normal(0, 0.01, rewards.shape)).astype(np.float32)
        np.testing.assert_array_equal(tctl.step_window(r),
                                      jctl.step_window(r))
        assert tctl.stats[-1].spend <= budget * (1 + 1e-6)
        np.testing.assert_allclose(tctl.stats[-1].lam, jctl.stats[-1].lam,
                                   rtol=1e-3)
        tctl.pd.lam = torch.tensor(jctl.stats[-1].lam)
    # a 5x spike at a pinned zero price: every request asks for its
    # favourite chain and the guard must downgrade down to the cap
    spike = np.tile(rewards, (5, 1))
    tctl.pd.lam = torch.tensor(0.0)
    tctl.step_window(spike)
    cap = max(budget, tc.costs[tc.cheapest()] * len(spike))
    assert tctl.stats[-1].spend <= cap * (1 + 1e-6)
    assert tctl.stats[-1].downgraded > 0
    assert np.array_equal(tctl.spend_trace(),
                          [s.spend for s in tctl.stats])


def test_budget_controller_from_spec():
    _, tc = PAPER
    spec = tspec.ConstraintSpec([tspec.GlobalAxis(budget=1e9)])
    assert tbudget.BudgetController.from_spec(tc, spec).budget_per_window \
        == 1e9
    with pytest.raises(ValueError, match="plain"):
        tbudget.BudgetController.from_spec(tc, tspec.ConstraintSpec(
            [tspec.TenantAxis((1.0, 2.0))]))
    with pytest.raises(ValueError, match="carbon"):
        tbudget.BudgetController.from_spec(tc, tspec.ConstraintSpec(
            [tspec.GlobalAxis(budget=1.0, pricing="carbon")]))


@pytest.mark.parametrize("flops", [0.0, 1e12, 3.7e15])
def test_pfec_matches_jax(flops):
    for cfg in (None, dict(pue=1.2, carbon_intensity_g_per_kwh=300.0)):
        jc = None if cfg is None else jpfec.EnergyConfig(**cfg)
        tc = None if cfg is None else tpfec.EnergyConfig(**cfg)
        assert tpfec.pfec_report(clicks=7, flops=flops, cfg=tc).as_row() \
            == jpfec.pfec_report(clicks=7, flops=flops, cfg=jc).as_row()
    assert tpfec.kwh_per_flop() == jpfec.kwh_per_flop()
    labels = np.array([0, 1, 1, 0, 1], np.int8)
    for e in (0, 2, 9):
        assert tpfec.revenue_at_e(labels, [4, 1, 0], e) \
            == jpfec.revenue_at_e(labels, [4, 1, 0], e)
    with pytest.raises(ValueError, match="pue"):
        tpfec.EnergyConfig(pue=0.5)


def test_allocator_facade_matches_jax(stack):
    """The same reward model (bridged) and chains: the port's facade
    scores within 1e-5 of the JAX one, decides as it does on all but
    near-ties, and meters the same overhead."""
    budget = 0.5 * float(stack.tchains.costs.max()) * 64
    ja = jalloc.GreenFlowAllocator(stack.jchains, stack.jparams,
                                   stack.jrcfg, budget)
    ta = talloc.GreenFlowAllocator(stack.tchains, stack.tparams,
                                   stack.trcfg, budget)
    agree = total = 0
    for ctx, _ in torch_tiny.windows(3, seed=5):
        np.testing.assert_allclose(ta.score(ctx).numpy(),
                                   np.asarray(ja.score(ctx)), rtol=1e-5,
                                   atol=1e-5)
        jd, td = ja.allocate_window(ctx), ta.allocate_window(ctx)
        agree += int((jd == td).sum())
        total += len(jd)
        ta.controller.pd.lam = torch.tensor(ja.lam)  # pin the next price
    assert agree / total >= 0.99
    assert ta.self_cost_flops(10) == ja.self_cost_flops(10)
    assert ta.report(5.0).meta["overhead_flops"] == pytest.approx(
        ja.report(5.0).meta["overhead_flops"])


def test_precompute_stage_scores_matches_jax():
    """Every stage model over the whole corpus, on bridged weights, for a
    slab of a small streamed world: within 1e-5 (f32 scores)."""
    import jax

    from repro.data.synthetic import StreamingWorld as JWorld
    from repro.data.synthetic import WorldConfig as JWorldConfig
    from repro.models.recsys import dien as jdien
    from repro.models.recsys import din as jdin
    from repro.models.recsys import dssm as jdssm
    from repro.models.recsys import ydnn as jydnn
    from repro_torch import bridge
    from repro_torch.data.synthetic import StreamingWorld as TWorld
    from repro_torch.data.synthetic import WorldConfig as TWorldConfig
    from repro_torch.models.recsys import dien, din, dssm, ydnn

    world = dict(n_users=500, n_items=64, hist_len=8, n_cats=10, seed=3)
    wc = JWorldConfig(**world)
    n_uf = wc.n_user_fields
    voc = dict(item_vocab=wc.n_items, user_vocab=n_uf * wc.user_field_vocab)
    rank = dict(voc, cat_vocab=wc.n_cats, n_user_fields=n_uf, embed_dim=4,
                seq_len=wc.hist_len, attn_hidden=(8, 4), mlp_hidden=(8, 4))
    cfgs = (dict(voc, n_user_fields=n_uf, n_item_fields=2, embed_dim=4,
                 hidden=(16, 8), d_out=4),
            dict(voc, n_user_fields=n_uf, hist_len=wc.hist_len, embed_dim=8,
                 hidden=(16, 8), d_out=6), rank, rank)
    jm, tm = [], []
    for i, (jmod, tmod, cfg, cls) in enumerate(zip(
            (jdssm, jydnn, jdin, jdien), (dssm, ydnn, din, dien), cfgs,
            ("DSSMConfig", "YDNNConfig", "DINConfig", "DIENConfig"))):
        jcfg, tcfg = getattr(jmod, cls)(**cfg), getattr(tmod, cls)(**cfg)
        jp = jmod.init(jax.random.PRNGKey(i), jcfg)
        jm += [jp, jcfg]
        tm += [bridge.from_numpy_tree(
            jax.tree_util.tree_map(np.asarray, jp),
            like=tmod.init(torch.Generator(), tcfg), device="cpu"), tcfg]
    users = np.arange(24)
    jslab = JWorld.build(wc).user_slab(users)
    tslab = TWorld.build(TWorldConfig(**world)).user_slab(users)
    want = jeng.precompute_stage_scores(jeng.CascadeModels(*jm), jslab,
                                        np.arange(24), item_block=64)
    got = teng.precompute_stage_scores(teng.CascadeModels(*tm), tslab,
                                       np.arange(24), item_block=64)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
