"""The port's request mesh in one process, against the JAX package.

  * the shard-ordered sums fold in shard order, and one shard runs the
    unsharded op itself;
  * the mesh's geometry (``process_shard_rows``, the pad quantum
    lcm(pad_quantum, S)), ``window_layout`` and ``MultihostSource``'s
    routed chunks mirror ``tests/test_multihost.py``'s host-side checks;
  * a one-shard mesh serves bit for bit as no mesh (plain and
    geotenants), and so does a one-process ``MultihostSource`` stream;
  * the guard and ``dual_descent`` at S = 1, 2, 4, 8 on power-of-two
    costs (every f32 sum exact) equal the JAX package's unsharded ones
    bit for bit;
  * the tiny stack served at S = 8 in one process against the JAX
    package's UNSHARDED pipeline (the sharded JAX reference diverges,
    ``tests/test_serving.py::test_pipeline_sharded_matches_unsharded``):
    decisions, downgrades, revenue and every spend exact at the JAX entry
    prices, the published prices within 1e-3 over a free-running stream,
    as the unsharded parity tests hold them;
  * stream checkpoints cross between the packages both ways, and the
    resumed stream equals the uninterrupted one;
  * the per-host labels of the flight recorder, as
    ``tests/test_multihost.py`` checks them;
  * the CLI: the JAX CLI's multi-process refusals word for word, and
    ``--shards 2`` serving.
"""
import json

import numpy as np
import pytest
import torch
import torch_mh_child
import torch_tiny

from torch_system import one_thread  # noqa: F401 (a fixture)
from repro.distributed import multihost as jmh
from repro.serving import spec as jspec
from repro.serving.guard import downgrade_guard as jguard
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro_torch.core.primal_dual import dual_descent
from repro_torch.distributed import multihost as mh
from repro_torch.distributed.sharding import (exclusive_shard_offset,
                                              ordered_psum, shard_prefix,
                                              shard_sum)
from repro_torch.launch import serve
from repro_torch.launch.mesh import (RequestMesh, make_request_mesh,
                                     mesh_local_shards, mesh_num_shards,
                                     process_shard_rows)
from repro_torch.serving import spec as tspec
from repro_torch.serving.guard import downgrade_guard
from repro_torch.serving.pipeline import ServingPipeline, window_layout
from repro_torch.serving.stream import run_stream

LAM_RTOL = 1e-3  # the published price, as the port's other parity tests
RESULT_FIELDS = ("decisions", "revenue", "spend", "downgraded", "flops",
                 "lam_before", "lam_after", "tenant_spend", "regions",
                 "region_spend", "tr_spend")


@pytest.fixture(scope="module")
def cheap():
    torch.set_num_threads(1)
    return torch_mh_child.build(torch.device("cpu"))


@pytest.fixture(scope="module")
def stack():
    return torch_tiny.build(pow2=True)


# ---------------------------------------------------------------------------
# Shard-ordered sums
# ---------------------------------------------------------------------------


def test_ordered_psum_folds_in_shard_order():
    parts = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    want = np.float32(1e8)
    for v in (1.0, -1e8, 1.0, 3.0):
        want = np.float32(want + np.float32(v))
    assert ordered_psum(parts).item() == want == 4.0
    assert torch.sum(parts).item() != want  # another association
    off = exclusive_shard_offset(parts)
    np.testing.assert_array_equal(off.numpy(), [0.0, 1e8, 1e8, 0.0, 1.0])
    vec = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    np.testing.assert_array_equal(exclusive_shard_offset(vec).numpy(),
                                  [[0, 0, 0], [0, 1, 2], [3, 5, 7],
                                   [9, 12, 15]])


def test_shard_sum_and_prefix():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=64)
                         .astype(np.float32))
    assert torch.equal(shard_sum(x, 1), torch.sum(x))
    p1, t1 = shard_prefix(x, 1)
    assert torch.equal(p1, torch.cumsum(x, 0)) and torch.equal(t1, p1[-1])
    for s in (2, 4, 8):
        parts = torch.sum(x.reshape(s, -1), dim=1)
        assert torch.equal(shard_sum(x, s), ordered_psum(parts))
        prefix, total = shard_prefix(x, s)
        local = torch.cumsum(x.reshape(s, -1), dim=1)
        want = local + exclusive_shard_offset(local[:, -1])[:, None]
        assert torch.equal(prefix, want.reshape(-1))
        assert torch.equal(total, ordered_psum(local[:, -1]))
        np.testing.assert_allclose(prefix.numpy(), p1.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_process_shard_rows_single_process():
    mesh = make_request_mesh(1)
    assert mesh_num_shards(mesh) == mesh_local_shards(mesh) == 1
    assert process_shard_rows(mesh, 64) == [(0, 64)]
    assert mesh_num_shards(None) == 1 and mesh_local_shards(None) == 1
    assert make_request_mesh().n_shards == 1  # one a process
    eight = make_request_mesh(8)
    assert process_shard_rows(eight, 64) == [(8 * s, 8 * s + 8)
                                             for s in range(8)]
    with pytest.raises(ValueError, match="not divisible"):
        process_shard_rows(eight, 60)
    # rank 1 of 4 over 8 shards owns shards 2 and 3
    m = RequestMesh(8, rank=1, world=4)
    assert (m.local_shards, m.first_shard) == (2, 2)
    assert process_shard_rows(m, 64) == [(16, 24), (24, 32)]
    with pytest.raises(ValueError, match="do not divide"):
        RequestMesh(6, world=4)


@pytest.mark.parametrize("shards,tenants,want", [
    (1, None, 32), (8, None, 32), (3, None, 96), (64, None, 64),
    (8, 3, 96), (3, 2, 96)])
def test_pad_quantum_is_lcm_with_shards(cheap, shards, tenants, want):
    chains, src, params, rcfg = cheap
    tb = None if tenants is None else np.full(tenants, 100.0, np.float32)
    pipe = ServingPipeline(src.universe, params, rcfg, 100.0,
                           mesh=make_request_mesh(shards), tenant_budgets=tb,
                           device="cpu")
    assert pipe.pad_quantum == want
    b = pipe.window_bucket(50 * (tenants or 1))
    assert b % shards == 0 and b % (tenants or 1) == 0


def test_window_layout_invariants():
    perm, valid, k_of = window_layout(50, 64, None)
    assert k_of is None
    np.testing.assert_array_equal(perm[valid > 0], np.arange(50))
    assert valid.sum() == 50 and (valid[:50] == 1).all()
    perm, valid, k_of = window_layout(36, 48, 2)
    np.testing.assert_array_equal(perm[valid > 0], np.arange(36))
    np.testing.assert_array_equal(np.bincount(k_of[valid > 0]), [18, 18])
    with pytest.raises(ValueError):
        window_layout(35, 48, 2)
    with pytest.raises(ValueError):
        window_layout(36, 49, 2)


def _pipe(cheap, mesh=None, tenants=None, **kw):
    chains, src, params, rcfg = cheap
    budget = 0.5 * float(chains.costs.max()) * 64
    return ServingPipeline(src.universe, params, rcfg, budget, mesh=mesh,
                           tenant_budgets=tenants,
                           tenant_mode=("priced" if tenants is not None
                                        else "shared"), device="cpu", **kw)


@pytest.mark.parametrize("shards", [1, 8])
def test_multihost_source_scatters_exact_table_slices(cheap, shards):
    """The routed chunk of a one-process mesh: every valid row's context
    and table columns are the inner source's rows for the laid-out users,
    pad rows carry the sentinel fill, rows index the chunk's tables."""
    src = cheap[1]
    pipe = _pipe(cheap, make_request_mesh(shards))
    msrc = mh.MultihostSource(src, pipe)
    t, n = 3, 50
    chunk = msrc.window(t, n)
    b = pipe.window_bucket(n)
    perm, valid, _ = window_layout(n, b, None)
    assert chunk.shard.n == n == chunk.n and chunk.shard.b == b
    np.testing.assert_array_equal(chunk.shard.valid, valid)
    np.testing.assert_array_equal(chunk.shard.rows_global, np.arange(b))
    np.testing.assert_array_equal(chunk.rows, np.arange(b))
    inner = src.window_for_users(src.arrivals(t, n)[perm[valid > 0]])
    m = valid > 0
    np.testing.assert_array_equal(chunk.ctx[m], inner.ctx)
    np.testing.assert_array_equal(chunk.tables["p"][:, m, :],
                                  inner.tables["p"])
    np.testing.assert_array_equal(chunk.tables["ck"][:, m, :],
                                  inner.tables["ck"])
    assert (chunk.tables["p"][:, ~m, :] == pipe._cap).all()
    assert (chunk.tables["ck"][:, ~m, :] == 0).all()
    assert (chunk.ctx[~m] == 0).all()


def test_multihost_source_tenant_blocks(cheap):
    pipe = _pipe(cheap, make_request_mesh(1),
                 tenants=np.asarray([100.0, 100.0], np.float32))
    msrc = mh.MultihostSource(cheap[1], pipe)
    n = 36
    chunk = msrc.window(0, n)
    b = pipe.window_bucket(n)
    _, valid, k_of = window_layout(n, b, 2)
    np.testing.assert_array_equal(chunk.shard.k_of, k_of)
    np.testing.assert_array_equal(chunk.shard.valid, valid)
    assert chunk.n == n and len(chunk.rows) == b


def test_multihost_source_device_tables_equal_host_tables(cheap):
    """A source whose chunk tables are tensors is scattered on their
    device, to the same rows as host tables."""
    from repro_torch.data.request_source import TableReplaySource

    src = cheap[1]
    dev_src = TableReplaySource(src.ctx, src.p_sorted, src.clicks_sorted,
                                src.chains, n_items=src.n_items,
                                expose=src.expose, seed=src.seed,
                                device_tables=True, device="cpu")
    pipe = _pipe(cheap, make_request_mesh(8))
    a = mh.MultihostSource(src, pipe).window(2, 40)
    b = mh.MultihostSource(dev_src, pipe).window(2, 40)
    assert isinstance(b.tables["p"], torch.Tensor)
    for k in ("p", "ck"):
        np.testing.assert_array_equal(b.tables[k].numpy(), a.tables[k])
    np.testing.assert_array_equal(a.ctx, b.ctx)


def test_multihost_source_needs_a_mesh(cheap):
    with pytest.raises(ValueError, match="mesh-attached"):
        mh.MultihostSource(cheap[1], _pipe(cheap))
    pipe = _pipe(cheap, make_request_mesh(1))
    chunk = cheap[1].window(0, 32)
    with pytest.raises(ValueError, match="multi-process mesh"):
        pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables,
                          shard=mh.MultihostSource(cheap[1], pipe)
                          .window(0, 32).shard)


# ---------------------------------------------------------------------------
# One shard is no mesh
# ---------------------------------------------------------------------------


def _stream(cheap, job, mesh, multihost=None, wrap=False):
    chains, src, params, rcfg = cheap
    pipe, sizes, bt, st = torch_mh_child.pipeline(job, chains, src, params,
                                                  rcfg, mesh, "cpu")
    if multihost is not None:
        pipe.multihost = multihost
    source = mh.MultihostSource(src, pipe) if wrap else src
    return run_stream(pipe, sizes, source, prefetch=0, budget_trace=bt,
                      scale_trace=st)


def _assert_same_windows(a, b):
    for t, (x, y) in enumerate(zip(a.windows, b.windows)):
        for name in RESULT_FIELDS:
            u, v = getattr(x, name), getattr(y, name)
            assert (u is None) == (v is None), (t, name)
            if u is not None:
                assert torch.equal(u, v), (t, name)
        np.testing.assert_array_equal(x.valid, y.valid)
        assert x.n_valid == y.n_valid


@pytest.mark.parametrize("job", ["plain", "geotenants"])
def test_one_shard_mesh_serves_as_no_mesh(cheap, job):
    ref = _stream(cheap, job, None)
    one = _stream(cheap, job, make_request_mesh(1))
    _assert_same_windows(ref, one)
    assert one.steady_compiles == 0
    assert all(c in (0, 3) for c in one.compiles)  # score, main, dual
    # a one-process stream of host slices, sentinel-padded rows and all
    routed = _stream(cheap, job, make_request_mesh(1), multihost=True,
                     wrap=True)
    _assert_same_windows(ref, routed)
    np.testing.assert_array_equal(routed.windows[0].rows_global,
                                  np.arange(len(ref.windows[0].valid)))


def test_sharded_stream_is_within_budget_and_warm(cheap):
    st = _stream(cheap, "plain", make_request_mesh(8))
    assert st.steady_compiles == 0
    c_max = float(cheap[0].costs.max())
    c_min = float(cheap[0].costs.min())
    for r in st.windows:
        assert float(r.spend) <= max(r.budget, r.n_valid * c_min) + c_max
        assert r.decisions.shape == (len(r.valid),)


# ---------------------------------------------------------------------------
# The guard and the dual loop at S shards vs the JAX package unsharded
# ---------------------------------------------------------------------------


def _pow2_window(seed, b=64, n_valid=50):
    rng = np.random.default_rng(seed)
    costs = (2.0 ** rng.integers(0, 10, size=12)).astype(np.float32)
    dec = rng.integers(0, 12, size=b).astype(np.int32)
    valid = np.zeros(b, np.float32)
    valid[:n_valid] = 1.0
    cheap = int(np.argmin(costs))
    budget = float(np.sum(costs[dec[:n_valid]]) * 0.4)
    k_of = rng.integers(0, 3, size=b).astype(np.int32)
    return costs, dec, valid, cheap, budget, k_of


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_guard_at_s_shards_equals_jax_unsharded(shards):
    import jax.numpy as jnp

    costs, dec, valid, cheap, budget, k_of = _pow2_window(shards)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    got = downgrade_guard(t(dec), t(costs), budget, cheap, t(valid),
                          n_shards=shards)
    want = jguard(jnp.asarray(dec), jnp.asarray(costs), budget, cheap,
                  jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1]) > 0
    budgets = np.asarray([budget / 3, budget / 2, budget / 4], np.float32)
    got = downgrade_guard(t(dec), t(costs), t(budgets), cheap, t(valid),
                          k_of=t(k_of), n_shards=shards)
    want = jguard(jnp.asarray(dec), jnp.asarray(costs),
                  jnp.asarray(budgets), cheap, jnp.asarray(valid),
                  k_of=jnp.asarray(k_of))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = downgrade_guard(t(dec), t(costs), t(budgets), cheap, t(valid),
                          k_of=t(k_of))
    for g, w in zip(got, one):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shards", [2, 8])
def test_dual_descent_at_s_shards_exact_sums(shards):
    """Power-of-two costs and a 0/1 mask make every sum of the loop exact:
    the shard-ordered loop then equals the unsharded one bit for bit."""
    rng = np.random.default_rng(3)
    costs = torch.from_numpy((2.0 ** rng.integers(0, 8, size=16))
                             .astype(np.float32))
    rewards = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    mask = torch.from_numpy((np.arange(64) < 50).astype(np.float32))
    budget = float(costs.max()) * 2
    lam1, g1 = dual_descent(rewards, costs, budget, 0.0, mask=mask)
    lam_s, g_s = dual_descent(rewards, costs, budget, 0.0, mask=mask,
                              n_shards=shards)
    assert torch.equal(lam1, lam_s) and torch.equal(g1, g_s)
    assert float(lam1) > 0
    member = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 3, size=64)), 3).float()
    lam0 = torch.zeros(3)
    budgets = torch.full((3,), budget / 3)
    v1 = dual_descent(rewards, costs[:, None], budgets, lam0, mask=mask,
                      member=member)
    vs = dual_descent(rewards, costs[:, None], budgets, lam0, mask=mask,
                      member=member, n_shards=shards)
    assert torch.equal(v1[0], vs[0]) and torch.equal(v1[1], vs[1])


# ---------------------------------------------------------------------------
# S = 8 in one process against the JAX package's unsharded pipeline
# ---------------------------------------------------------------------------


def _spec_plan(stack, mode):
    """(spec factory, per-window (n, budget, cost_scale)) of a mode, as
    ``tests/test_torch_spec.py`` plans them."""
    c_max = float(stack.jchains.costs.max())
    if mode == "plain":
        b = 0.5 * c_max * 64
        return (lambda s: s.ConstraintSpec([s.GlobalAxis(budget=b)]),
                [(64, None, None), (60, 0.3 * b, 0.5), (64, b, 2.0),
                 (50, None, None)])
    tb = tuple(c_max * 32 * f for f in (0.25, 0.5, 1.5))
    if mode.startswith("tenants"):
        priced = mode == "tenants_priced"
        return (lambda s: s.ConstraintSpec(
            [s.TenantAxis(tb[:2], priced=priced),
             s.GlobalAxis(budget=sum(tb[:2]))]),
                [(64, None, None), (60, np.array(tb[1:]), 0.5),
                 (64, np.array(tb[:2]) * 2, 1.0), (62, None, 2.0)])
    if mode.startswith("geo_"):
        r_b = 0.3 * c_max * 64
        return (lambda s: s.ConstraintSpec(
            [s.RegionAxis(2, split=mode[4:]),
             s.GlobalAxis(budget=2 * r_b)]),
                [(64, np.array([r_b, r_b]), np.array([1.0, 1.0])),
                 (60, np.array([2 * r_b, r_b]), np.array([1.0, 0.5])),
                 (64, np.array([r_b, 0.5 * r_b]), np.array([0.5, 1.0])),
                 (64, np.array([r_b, 3 * r_b]), np.array([2.0, 2.0]))])
    rg = 0.4 * sum(tb)
    return (lambda s: s.ConstraintSpec(
        [s.TenantAxis(tb, priced=mode == "geotenants"), s.RegionAxis(2),
         s.GlobalAxis(pricing="carbon")]),
            [(96, np.array([*tb, rg, rg]), np.array([1.0, 1.0])),
             (90, np.array([*tb, rg, 0.5 * rg]), np.array([1.0, 0.5])),
             (96, np.array([*tb, 2 * rg, rg]), np.array([2.0, 1.0])),
             (96, np.array([*tb, rg, rg]), np.array([0.5, 0.5]))])


def _kw(budget, scale):
    return {k: v for k, v in (("budget", budget), ("cost_scale", scale))
            if v is not None}


@pytest.mark.parametrize("mode", ["plain", "tenants_shared",
                                  "tenants_priced", "geo_flow", "geo_argmax",
                                  "geotenants", "geotenants_shared"])
def test_sharded_matches_jax_unsharded_at_pinned_prices(stack, mode):
    make, plan = _spec_plan(stack, mode)
    jpipe = JPipeline.from_spec(stack.jserver, stack.jparams, stack.jrcfg,
                                make(jspec))
    tpipe = torch_tiny.FedPipeline.from_spec(stack, make(tspec),
                                             mesh=make_request_mesh(8))
    wins = torch_tiny.windows(len(plan), n=max(p[0] for p in plan), seed=21)
    downgraded = 0
    for t, ((n, budget, scale), (ctx, rows)) in enumerate(zip(plan, wins)):
        ctx, rows = ctx[:n], rows[:n]
        lam = np.asarray(jpipe.lam)
        jr = jpipe.serve_window(ctx, rows, **_kw(budget, scale))
        tr = tpipe.serve_window(ctx, rows, lam=lam, **_kw(budget, scale))
        assert tr.bucket[:2] == jr.bucket[:2], (mode, t)
        np.testing.assert_array_equal(tr.valid, jr.valid)
        np.testing.assert_array_equal(tr.decisions_np, jr.decisions_np)
        np.testing.assert_array_equal(tr.revenue_np, jr.revenue_np)
        assert int(tr.downgraded) == int(jr.downgraded)
        for name in ("spend", "flops", "tenant_spend", "region_spend",
                     "tr_spend"):
            got, want = getattr(tr, name), getattr(jr, name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{mode} {t} {name}")
        if jr.regions is not None:
            np.testing.assert_array_equal(tr.regions_np, jr.regions_np)
        np.testing.assert_allclose(tr.lam_after.numpy(),
                                   np.asarray(jr.lam_after), rtol=LAM_RTOL,
                                   atol=1e-12)
        downgraded += int(tr.downgraded)
    assert downgraded > 0


def test_sharded_stream_prices_track_jax_unsharded(stack):
    """A free-running stream (each package at its own prices) at S = 8:
    the published prices within 1e-3 of the JAX package's every window."""
    make, plan = _spec_plan(stack, "plain")
    jpipe = JPipeline.from_spec(stack.jserver, stack.jparams, stack.jrcfg,
                                make(jspec))
    tpipe = torch_tiny.FedPipeline.from_spec(stack, make(tspec),
                                             mesh=make_request_mesh(8))
    for n, budget, scale in plan * 2:
        ctx, rows = torch_tiny.windows(1, n=n, seed=n)[0]
        jr = jpipe.serve_window(ctx, rows, **_kw(budget, scale))
        tr = tpipe.serve_window(ctx, rows, **_kw(budget, scale))
        np.testing.assert_allclose(tr.lam_after.numpy(),
                                   np.asarray(jr.lam_after), rtol=LAM_RTOL,
                                   atol=1e-12)
    assert float(jpipe.lam) > 0


# ---------------------------------------------------------------------------
# Stream checkpoints, both ways across the packages
# ---------------------------------------------------------------------------


def test_stream_checkpoint_roundtrip(cheap, tmp_path):
    src = cheap[1]
    pipe = _pipe(cheap, make_request_mesh(8))
    chunk = src.window(0, 40)
    pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables)
    saved = pipe.lam.clone()
    path = mh.checkpoint_stream(str(tmp_path / "ck.json"), pipe, t_next=4,
                                seed=src.seed)
    blob = json.load(open(path))
    assert set(blob) == {"t_next", "lam", "lam_rec", "seed", "n_shards"}
    assert blob["n_shards"] == 8
    pipe.lam.zero_()
    ck = mh.restore_stream(path, pipe)
    assert ck.t_next == 4 and ck.seed == src.seed
    assert torch.equal(pipe.lam, saved)
    shifted = mh.ShiftedSource(src, 4)
    np.testing.assert_array_equal(shifted.arrivals(0, 32),
                                  src.arrivals(4, 32))
    a, b = shifted.window(1, 24), src.window(5, 24)
    np.testing.assert_array_equal(a.ctx, b.ctx)
    np.testing.assert_array_equal(a.tables["p"], b.tables["p"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_checkpoint_crosses_packages(stack, tmp_path, writer):
    """A stream checkpointed after window 2 by one package resumes in the
    other at window 3; the resumed windows equal the other package's
    uninterrupted stream (decisions exact, prices within 1e-3) and the
    restored price is the written one bit for bit."""
    budget = 0.5 * float(stack.jchains.costs.max()) * 64
    wins = [w for w in torch_tiny.windows(6, n=64, seed=9)]
    path = str(tmp_path / "ck.json")

    def port_pipe():
        return torch_tiny.FedPipeline(stack, budget,
                                      mesh=make_request_mesh(8))

    def jax_pipe():
        return JPipeline(stack.jserver, stack.jparams, stack.jrcfg, budget)

    full_j, full_t = jax_pipe(), port_pipe()
    want_j = [full_j.serve_window(*w) for w in wins]
    want_t = [full_t.serve_window(*w) for w in wins]
    first = jax_pipe() if writer == "jax" else port_pipe()
    for w in wins[:3]:
        first.serve_window(*w)
    if writer == "jax":
        jmh.checkpoint_stream(path, first, t_next=3, seed=9)
        second, want = port_pipe(), want_t
        ck = mh.restore_stream(path, second)
        written = np.asarray(first.lam)
        got_lam = second.lam.numpy()
    else:
        mh.checkpoint_stream(path, first, t_next=3, seed=9)
        second, want = jax_pipe(), want_j
        ck = jmh.restore_stream(path, second)
        written = first.lam.numpy()
        got_lam = np.asarray(second.lam)
    assert ck.t_next == 3 and ck.seed == 9
    np.testing.assert_array_equal(got_lam, written)
    for t in range(ck.t_next, len(wins)):
        r = second.serve_window(*wins[t])
        np.testing.assert_array_equal(np.asarray(r.decisions_np),
                                      np.asarray(want[t].decisions_np))
        np.testing.assert_allclose(np.asarray(r.lam_after),
                                   np.asarray(want[t].lam_after),
                                   rtol=LAM_RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# Bring-up and the per-host labels
# ---------------------------------------------------------------------------


def test_initialize_noop_without_coordinator(monkeypatch):
    for k in ("GREENFLOW_COORDINATOR", "GREENFLOW_NUM_PROCESSES",
              "GREENFLOW_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize() is False
    assert mh.initialize(num_processes=1) is False
    assert mh.initialize(num_processes=4) is False
    assert mh.initialize(coordinator="127.0.0.1:1", num_processes=1) is False


def test_host_report_and_label():
    rep = mh.host_report(make_request_mesh(8), "cpu")
    assert rep["process_count"] == 1 and rep["process_index"] == 0
    assert rep["local_shards"] == rep["global_shards"] == 8
    assert rep["platform"] == "cpu"
    assert mh.host_label() == "host0" and mh.host_label(3) == "host3"


def test_tracer_process_label_and_merge(tmp_path):
    from repro_torch.obs import Tracer, merge_chrome_traces

    paths = []
    for h in range(2):
        tr = Tracer(process_label=f"host{h}")
        with tr.span("serve", t=0):
            pass
        paths.append(tr.write(str(tmp_path / f"trace{h}.json")))
    merged = merge_chrome_traces(paths,
                                 out_path=str(tmp_path / "merged.json"))
    names = [e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"]
    assert sorted(names) == ["host0", "host1"]
    with open(tmp_path / "merged.json") as f:
        again = json.load(f)
    assert len(again["traceEvents"]) == len(merged["traceEvents"])
    spans = [e for e in again["traceEvents"] if e.get("ph") == "X"]
    assert len(spans) == 2


def test_window_event_host_label(cheap):
    from repro_torch.obs import Obs, window_event

    pipe = _pipe(cheap, make_request_mesh(2))
    chunk = cheap[1].window(0, 32)
    r = pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables)
    row = window_event(0, r, 1.0, host="host5")
    assert row["host"] == "host5"
    assert window_event(0, r, 1.0).get("host") is None
    assert Obs(host="host2").tracer.process_label == "host2"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

REFUSALS = [
    ["--processes", "2", "--source", "table"],
    ["--processes", "2", "--legacy"],
    ["--processes", "2", "--source", "generated", "--shards", "2"],
    ["--processes", "2", "--source", "generated"],  # no coordinator
    ["--processes", "2", "--source", "generated", "--scenario", "tenants",
     "--tenant-mode", "independent", "--coordinator", "127.0.0.1:1"],
]


@pytest.mark.parametrize("argv", REFUSALS[:4])
def test_cli_refusals_are_the_jax_clis(monkeypatch, argv):
    """Both CLIs refuse these before any training, with the same
    message."""
    import sys

    from repro import experiments as jexp
    from repro.launch import serve as jserve
    from repro_torch import experiments

    for k in ("GREENFLOW_COORDINATOR", "GREENFLOW_NUM_PROCESSES",
              "GREENFLOW_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)

    def no_training(*a, **k):
        raise AssertionError("trained before refusing")

    monkeypatch.setattr(experiments, "build_serving_stack", no_training)
    monkeypatch.setattr(jserve, "build_serving_stack", no_training)
    monkeypatch.setattr(jexp, "build_serving_stack", no_training)
    with pytest.raises(SystemExit) as got:
        serve.main(["--small", "--device", "cpu", *argv])
    monkeypatch.setattr(sys, "argv", ["serve", "--small", *argv])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    assert str(got.value) == str(want.value) and str(got.value)


def test_cli_refuses_independent_tenants_over_processes(monkeypatch):
    from repro_torch import experiments

    monkeypatch.setattr(experiments, "build_serving_stack",
                        lambda *a, **k: pytest.fail("trained"))
    with pytest.raises(SystemExit, match="one pipeline per tenant"):
        serve.main(["--small", "--device", "cpu", *REFUSALS[4]])


def test_cli_serves_over_two_shards(capsys, one_thread, tmp_path):
    assert serve.main(["--small", "--device", "cpu", "--source",
                       "generated", "--shards", "2", "--windows", "3",
                       "--requests", "32", "--users", "2000",
                       "--metrics-out", str(tmp_path / "m.prom")]) == 0
    out = capsys.readouterr().out
    assert "worst overshoot vs cap: 0.000%" in out
    rows = [json.loads(line) for line in
            open(tmp_path / "m.prom.windows.jsonl")]
    assert len(rows) == 3 and all("host" not in r for r in rows)
