"""The serving CLI's trained stack, request sources and legacy loops, and
the greenflow-cascade cells, against the JAX package.

The CLI runs (``serve.main --small --device cpu``) share one trained
``--small`` stack through the experiment cache.  The parity tests use
the ``system_exp`` stack carried over (``tests/torch_system.py``):

  * the legacy window: rewards within 1e-5 of the JAX scorer's;
    ``make_legacy_window`` fed the JAX rewards at the JAX entry price:
    decisions, downgrades and revenue exact, the price within 1e-3;
  * the legacy carbon loop and the table-source carbon day: ledger rows
    with the same integers and floats within 1e-5 relative, both
    packages fed the JAX reward matrix (the fused day at the JAX run's
    entry prices);
  * the four greenflow-cascade cells at ``smoke_config`` against the JAX
    cells' ``fn``, and ``smoke_loss``.
"""
import csv
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_system
from torch_system import one_thread  # noqa: F401 (a fixture)
from repro.carbon.controller import CarbonBudget as JCarbonBudget
from repro.carbon.intensity import diurnal_trace as jdiurnal
from repro.carbon.ledger import CarbonLedger as JLedger
from repro.configs import greenflow_cascade as jgc
from repro.core import reward_model as jrm
from repro.launch import serve as jserve
from repro.models.recsys import din as jdin
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs import greenflow_cascade as tgc
from repro_torch.launch import cells
from repro_torch.launch import serve
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.stream import run_stream

LEDGER_RTOL = 1e-5
LAM_RTOL = 1e-3  # the published price, as the port's other parity tests


def _main(capsys, *argv) -> str:
    assert serve.main(["--small", "--device", "cpu", *argv]) == 0
    return capsys.readouterr().out


def _rows(out: str, header: str) -> list[str]:
    """The window table's rows after the line that starts with
    ``header``."""
    lines = out.splitlines()
    at = next(i for i, line in enumerate(lines)
              if line.split()[:len(header.split())] == header.split())
    rows = []
    for line in lines[at + 1:]:
        if not line.strip() or not line.split()[0].isdigit():
            break
        rows.append(line)
    return rows


# ---------------------------------------------------------------------------
# The CLI on the CPU
# ---------------------------------------------------------------------------


def test_cli_defaults_are_the_jax_clis():
    args = serve.parser().parse_args([])
    assert (args.windows, args.requests, args.scenario, args.source,
            args.legacy, args.users) == (12, 96, "spike", "table", False,
                                         100_000)
    assert args.replay_dir is None and args.device is None


def test_cli_default_run_serves_the_trained_table_source(capsys,
                                                         one_thread):
    out = _main(capsys)
    assert "training cascade & reward models" in out
    assert "evaluation users of the trained experiment" in out
    rows = _rows(out, "win n spend/budget")
    assert [int(r.split()[1]) for r in rows] == [96] * 4 + [288] * 3 + \
        [96] * 5
    assert "worst overshoot vs cap: 0.000%" in out and "PFEC" in out


def test_cli_memmap_saves_then_loads(capsys, tmp_path, one_thread):
    path = tmp_path / "universe"
    first = _main(capsys, "--source", "memmap", "--replay-dir", str(path),
                  "--windows", "3")
    assert f"saving replay universe -> {path}" in first
    assert {p.name for p in path.iterdir()} == {
        "ctx.npy", "p_sorted.npy", "clicks_sorted.npy", "meta.json"}
    second = _main(capsys, "--source", "memmap", "--replay-dir", str(path),
                   "--windows", "3")
    assert "saving" not in second and "memmapped replay of U=160" in second

    def served(out):  # win, n, spend/budget, lam, downgraded, revenue
        return [r.split()[:6] for r in _rows(out, "win n spend/budget")]

    assert len(served(first)) == 3 and served(first) == served(second)


def test_cli_generated_source_over_the_trained_models(capsys, one_thread):
    out = _main(capsys, "--source", "generated", "--users", "3000",
                "--windows", "2", "--scenario", "constant")
    assert "generated stream over U=3,000" in out
    assert len(_rows(out, "win n spend/budget")) == 2


@pytest.mark.parametrize("scenario", ["spike", "carbon"])
def test_cli_legacy_loops(capsys, tmp_path, one_thread, scenario):
    report = tmp_path / "carbon.csv"
    out = _main(capsys, "--legacy", "--scenario", scenario, "--windows",
                "4", "--carbon-report", str(report))
    if scenario == "carbon":
        rows = _rows(out, "win n ci_g/kwh spend_g/budget_g")
        assert "all-max base" in out and report.exists()
        assert len(report.read_text().splitlines()) == 1 + 5
    else:
        rows = _rows(out, "win n spend/budget lam downgraded revenue "
                          "window_ms")
    assert len(rows) == 4 and "PFEC" in out


@pytest.mark.parametrize("argv,message", [
    (["--legacy", "--source", "memmap"],
     "--legacy indexes the materialized server; the streaming --source "
     "forms have no legacy loop"),
    (["--legacy", "--source", "generated"],
     "--legacy indexes the materialized server; the streaming --source "
     "forms have no legacy loop"),
    (["--legacy", "--scenario", "georegions"],
     "--scenario georegions has no legacy loop (the router exists only in "
     "the fused pass)"),
    (["--legacy", "--scenario", "geotenants"],
     "--scenario geotenants has no legacy loop (the combined tenant x "
     "region pass exists only in the fused pipeline)"),
])
def test_cli_refuses_as_the_jax_cli(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        serve.main(["--small", "--device", "cpu", *argv])
    assert str(e.value) == message
    assert "training" not in capsys.readouterr().out  # refused first


# ---------------------------------------------------------------------------
# The legacy host loops against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sys(system_exp, system_reward):
    return torch_system.carry(system_exp, system_reward)


def test_legacy_window_matches_jax(sys, monkeypatch):
    """The port's scorer within 1e-5 of the JAX one; the port's
    ``make_legacy_window`` (controller, guard, price update, server)
    fed the JAX rewards at the JAX controller's entry price decides,
    downgrades and serves as JAX's window, and publishes its price."""
    budget = 0.6 * float(sys.tchains.costs.max()) * 64
    jscore = jserve.make_legacy_scorer(sys.jexp, sys.jrcfg)
    tscore = serve.make_legacy_scorer(sys.texp, sys.trcfg, "cpu")
    jctl, jwindow = jserve.make_legacy_window(sys.jexp, sys.jserver,
                                              sys.jparams, sys.jrcfg, budget)
    monkeypatch.setattr(serve, "make_legacy_scorer",
                        lambda exp, rcfg, device=None: lambda p, ctx:
                        torch.from_numpy(np.array(jscore(sys.jparams,
                                                         jnp.asarray(ctx)))))
    tctl, twindow = serve.make_legacy_window(sys.texp, sys.tserver,
                                             sys.tparams, sys.trcfg, budget)
    rng = np.random.default_rng(0)
    for t, n in enumerate((64, 192, 64)):
        rows = rng.integers(0, len(sys.texp.ctx_eval), n)
        ctx = sys.texp.ctx_eval[rows]
        jr = np.asarray(jscore(sys.jparams, jnp.asarray(ctx)))
        np.testing.assert_allclose(tscore(sys.tparams, ctx).numpy(), jr,
                                   rtol=1e-5, atol=1e-5)
        tctl.pd.lam = float(jctl.pd.lam)  # the JAX controller's entry price
        jdec, jrev = jwindow(ctx, rows)
        tdec, trev = twindow(ctx, rows)
        np.testing.assert_array_equal(tdec, jdec)
        np.testing.assert_array_equal(trev, jrev)
        assert tctl.stats[-1].downgraded == jctl.stats[-1].downgraded
        np.testing.assert_allclose(tctl.stats[-1].lam, jctl.stats[-1].lam,
                                   rtol=LAM_RTOL)
    assert sum(s.downgraded for s in jctl.stats) > 0


def _table_sampler_jax(jexp):
    rng = np.random.default_rng(0)
    n_eval = jexp.ctx_eval.shape[0]

    def sample_window(t, n):
        rows = rng.integers(0, n_eval, n)
        return jexp.ctx_eval[rows], rows

    return sample_window


def _csv(path) -> list[list[str]]:
    with open(path) as f:
        return list(csv.reader(f))


def _same_ledger(got_path, want_path):
    got, want = _csv(got_path), _csv(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(want[0], g_row, w_row):
            try:
                assert int(g) == int(w), col
            except ValueError:
                if g == w:
                    continue
                np.testing.assert_allclose(float(g), float(w),
                                           rtol=LEDGER_RTOL, err_msg=col)


@pytest.mark.parametrize("loop", ["legacy", "fused"])
def test_carbon_day_on_the_table_source_matches_jax(sys, tmp_path,
                                                    monkeypatch, loop):
    """``_legacy_carbon_loop`` and the table-source ``carbon_day`` against
    the JAX package's ``_legacy_carbon_loop`` and ``_carbon_stream``,
    both packages fed the JAX reward matrix."""
    args = serve.parser().parse_args([
        "--scenario", "carbon", "--windows", "4", "--requests", "64",
        "--prefetch", "0", "--carbon-report", str(tmp_path / "port.csv")])
    sizes = serve._day_sizes(args)
    budget = float(0.6 * sys.tchains.costs.max() * 64)
    window_s = 86400.0 / len(sizes)
    trace = jdiurnal(mean=450.0)
    cb = JCarbonBudget.from_flops(budget, trace, window_s=window_s)
    jledger = JLedger(sys.jexp.chains, trace, window_s=window_s,
                      phase_s=cb.phase_s,
                      embodied_g_per_device_h=serve._embodied(args))
    sample = _table_sampler_jax(sys.jexp)
    full = jax.jit(lambda p, c: jrm.denormalize_rewards(p, jrm.reward_matrix(
        p, sys.jrcfg, c, jnp.asarray(sys.jexp.chains.model_onehot),
        jnp.asarray(sys.jexp.chains.scale_multihot))))
    if loop == "legacy":
        import repro.carbon.controller as jctl_mod

        jctls = []

        class Recorded(jctl_mod.CarbonBudgetController):
            def __post_init__(self):
                super().__post_init__()
                jctls.append(self)

        monkeypatch.setattr(jctl_mod, "CarbonBudgetController", Recorded)
        jserve._legacy_carbon_loop(sys.jexp, sys.jserver, sys.jparams,
                                   sys.jrcfg, sizes, cb, jledger, sample,
                                   "carbon")
        entry = [0.0] + [s.lam for s in jctls[0].stats[:-1]]

        def fed_scorer(exp, rcfg, device=None):
            return lambda params, ctx: torch.from_numpy(np.array(
                full(sys.jparams, jnp.asarray(ctx, jnp.float32))))

        class Pinned(serve.CarbonBudgetController):
            """Each window decided at the JAX controller's entry price."""

            def step_window(self, rewards):
                self.lam = torch.tensor(entry[len(self.stats)],
                                        dtype=torch.float32)
                return super().step_window(rewards)

        monkeypatch.setattr(serve, "make_legacy_scorer", fed_scorer)
        monkeypatch.setattr(serve, "CarbonBudgetController", Pinned)
    else:
        jserve._carbon_stream(sys.jserver, sys.jparams, sys.jrcfg, sizes, cb,
                              jledger, sample, "carbon", prefetch=0)

        class Fed(ServingPipeline):
            def _rewards(self, ctx):
                return torch.from_numpy(np.array(sys.reward_fn(
                    sys.jparams, jnp.asarray(ctx.numpy()))))

        lams = _jax_entry_prices(sys, sizes, cb)
        monkeypatch.setattr(serve, "ServingPipeline", Fed)
        monkeypatch.setattr(serve, "run_stream",
                            functools.partial(run_stream, lam_trace=lams))
    jledger.to_csv(str(tmp_path / "jax.csv"))
    stack = serve.ServeStack(
        serve.table_sampler(sys.texp), [], sizes, budget,
        float(sys.tchains.costs.max()), torch.device("cpu"), sys.tparams,
        sys.trcfg, server=sys.tserver, exp=sys.texp)
    if loop == "legacy":
        serve.legacy_carbon_day(stack, args)
    else:
        day = serve.carbon_day(stack, args)
        assert day.total_revenue > 0
    _same_ledger(tmp_path / "port.csv", tmp_path / "jax.csv")


def _jax_entry_prices(sys, sizes, cb) -> list:
    """Each window's entry price in the JAX package's fused carbon day
    (``_carbon_stream``'s pipeline and run, repeated on a fresh
    sampler)."""
    from repro.serving.pipeline import ServingPipeline as JPipeline
    from repro.serving.stream import run_stream as jrun

    pipe = JPipeline(sys.jserver, sys.jparams, sys.jrcfg, cb.flops_ref)
    sched = cb.schedule(len(sizes))
    st = jrun(pipe, sizes, _table_sampler_jax(sys.jexp),
              budget_trace=sched["grams"], scale_trace=sched["scale"],
              prefetch=0)
    return [np.asarray(r.lam_before) for r in st.windows]


# ---------------------------------------------------------------------------
# The greenflow-cascade cells at smoke_config against the JAX cells
# ---------------------------------------------------------------------------


def _jax_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture()
def jax_cells(monkeypatch):
    """The JAX cells at the port's smoke sizes: the reward model at
    ``smoke_config``, DIN at its smoke widths, the smoke request
    counts."""
    from repro.configs import din_arch as jdin_arch

    monkeypatch.setattr(jgc, "full_config", jgc.smoke_config)
    sizes = tgc.SMOKE_SIZES
    for name, key in (("N_REQ_SERVE", "reward_serve"),
                      ("N_REQ_NEARLINE", "nearline_dual"),
                      ("N_REQ_TRAIN", "reward_train"),
                      ("RANK_BATCH", "rank_batch"),
                      ("RANK_CANDS", "rank_cands")):
        monkeypatch.setattr(jgc, name, sizes[key])
    smoke_din = jdin_arch.smoke_config()
    monkeypatch.setattr(jgc, "din_model", SimpleNamespace(
        DINConfig=lambda **kw: smoke_din, init=jdin.init, score=jdin.score,
        flops_per_item=jdin.flops_per_item))
    return jgc


@pytest.mark.parametrize("shape", tgc.SHAPES)
def test_greenflow_cascade_cell_matches_jax(jax_cells, shape):
    cfg = tgc.smoke_config()
    cell = tgc.make_cell(shape, cfg=cfg)
    args = cell.make_args(0, "cpu")
    jcell = jax_cells.make_cell(shape)
    assert cell.meta["model_flops"] == pytest.approx(
        jcell.meta["model_flops"], rel=1e-12)
    if shape == "reward_serve":
        params, ctx, lam, *_ = args
        jp = _jax_params_of(params)
        jdec, jr = jcell.fn(jp, jnp.asarray(ctx.numpy()),
                            jnp.float32(float(lam)))
        dec, r = cell.fn(*args)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-5)
        # decisions on the JAX rewards at the same price: exact
        from repro_torch.core.primal_dual import allocate
        np.testing.assert_array_equal(
            allocate(torch.from_numpy(np.array(jr)), args[5], lam).numpy(),
            np.asarray(jdec))
        assert len(set(dec.tolist())) > 1
    elif shape == "nearline_dual":
        rewards, lam0, costs = args
        jlam, jgaps = jcell.fn(jnp.asarray(rewards.numpy()), jnp.float32(0))
        lam, gaps = cell.fn(*args)
        assert float(jlam) > 0
        np.testing.assert_allclose(float(lam), float(jlam), rtol=1e-3)
        np.testing.assert_allclose(gaps.numpy()[0], np.asarray(jgaps)[0],
                                   rtol=1e-6)
    elif shape == "reward_train":
        state, batch = args
        jp = _jax_params_of(state.params)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        from repro.training.optimizer import AdamW as JAdamW
        from repro.training.trainer import init_state as jinit
        jnew, jloss = jcell.fn(jinit(jax.tree_util.tree_map(
            jnp.asarray, jp), JAdamW()), jb)
        new, loss = cell.fn(state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        got = dict(_flat(new.params))
        want = dict(_flat(_jax_params(jnew.params)))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    else:
        params, user, cid, ccat = args
        jp = jax.tree_util.tree_map(jnp.asarray, _jax_params_of(params))
        jb = {k: jnp.asarray(v.numpy()) for k, v in user.items()}
        want = jcell.fn(jp, jb, jnp.asarray(cid.numpy()),
                        jnp.asarray(ccat.numpy()))
        np.testing.assert_allclose(cell.fn(*args).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, (tree.detach().numpy() if isinstance(tree, torch.Tensor)
                       else np.asarray(tree))


def _jax_params_of(tree):
    """A port parameter tree as numpy leaves in the JAX layout."""
    if isinstance(tree, dict):
        return {k: _jax_params_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_params_of(v) for v in tree]
    return tree.detach().numpy()


def test_greenflow_cascade_smoke_loss_matches_jax():
    cfg, jcfg = tgc.smoke_config(), jgc.smoke_config()
    jp = _jax_params(jgc.init_smoke(jax.random.PRNGKey(0), jcfg))
    tp = bridge.from_numpy_tree(
        jp, like=tgc.init_smoke(torch.Generator(), cfg), device="cpu")
    jb = jgc.smoke_batch(np.random.default_rng(4), jcfg)
    tb = tgc.smoke_batch(np.random.default_rng(4), cfg)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_allclose(
        float(tgc.smoke_loss(tp, cfg, tb)),
        float(jgc.smoke_loss(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                             jb)), rtol=1e-5)
    assert get_arch("greenflow-cascade") is tgc


def test_cells_cli_runs_the_greenflow_cascade_shapes(capsys):
    for shape in tgc.SHAPES:
        assert cells.main(["--arch", "greenflow-cascade", "--shape", shape,
                           "--preset", "smoke", "--device", "cpu",
                           "--calls", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("decisions (64,) checksum") == 2
    assert out.count("lambda () checksum") == 2
    assert out.count("loss") == 2 and out.count("logits (4, 20)") == 2
