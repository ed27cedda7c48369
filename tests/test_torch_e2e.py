"""End to end: the JAX ``GeneratedSource`` + ``ServingPipeline`` against
the port's, three windows of a small streamed world on bridged weights.

1. Fed the JAX chunk tables and the JAX reward matrix, with the price
   pinned per window, the port's decisions, revenue, spend and
   downgrade counts are EXACT.  The chain space uses power-of-two FLOPs
   per item so every f32 cost sum is exact and no summation order can
   differ (the decisions would match on any costs; the spend would not).
2. From raw inputs - the port generates its own windows, scores its own
   stage and reward models, and runs its own price - the decisions
   agree on >= 99.5% of requests and lambda within 1e-3 relative (f32
   scores and sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cascade import engine as jeng
from repro.core import action_chain as jac
from repro.core import reward_model as jrm
from repro.data import request_source as jrs
from repro.data.synthetic import StreamingWorld as JWorld
from repro.data.synthetic import WorldConfig as JWorldConfig
from repro.models.recsys import dien as jdien
from repro.models.recsys import din as jdin
from repro.models.recsys import dssm as jdssm
from repro.models.recsys import ydnn as jydnn
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.stream import run_stream as jrun_stream
from repro_torch import bridge
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac
from repro_torch.core import reward_model as trm
from repro_torch.data import request_source as trs
from repro_torch.data.synthetic import StreamingWorld as TWorld
from repro_torch.data.synthetic import WorldConfig as TWorldConfig
from repro_torch.models.recsys import dien, din, dssm, ydnn
from repro_torch.serving.pipeline import ServingPipeline as TPipeline
from repro_torch.serving.stream import run_stream as trun_stream

SIZES = [48, 64, 40]
EXPOSE = 6
SEED = 5
WORLD = dict(n_users=5000, n_items=120, hist_len=8, n_cats=10, seed=3)
FLOPS = (2.0, 16.0, 512.0, 1024.0)  # DSSM, YDNN, DIN, DIEN per item


def _chains(ac):
    return ac.generate_action_chains((
        ac.StageSpec("recall", (ac.ModelInstance("DSSM", FLOPS[0]),),
                     (120,), 4),
        ac.StageSpec("prerank", (ac.ModelInstance("YDNN", FLOPS[1]),),
                     (24, 36, 48, 60), 4),
        ac.StageSpec("rank", (ac.ModelInstance("DIN", FLOPS[2]),
                              ac.ModelInstance("DIEN", FLOPS[3])),
                     (6, 12, 18, 24), 4)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks():
    wj = JWorldConfig(**WORLD)
    n_uf, ufv = wj.n_user_fields, wj.user_field_vocab
    voc = dict(item_vocab=wj.n_items, user_vocab=n_uf * ufv)
    rank = dict(voc, cat_vocab=wj.n_cats, n_user_fields=n_uf, embed_dim=4,
                seq_len=wj.hist_len, attn_hidden=(8, 4), mlp_hidden=(8, 4))
    cfgs = {
        "dssm": dict(voc, n_user_fields=n_uf, n_item_fields=1, embed_dim=4,
                     hidden=(16, 8), d_out=4),
        "ydnn": dict(voc, n_user_fields=n_uf, hist_len=wj.hist_len,
                     embed_dim=8, hidden=(16, 8), d_out=6),
        "din": rank, "dien": rank,
    }
    key = jax.random.PRNGKey(11)
    jmods, tmods = {}, {}
    for i, (name, jm, tm, jc, tc) in enumerate((
            ("dssm", jdssm, dssm, jdssm.DSSMConfig, dssm.DSSMConfig),
            ("ydnn", jydnn, ydnn, jydnn.YDNNConfig, ydnn.YDNNConfig),
            ("din", jdin, din, jdin.DINConfig, din.DINConfig),
            ("dien", jdien, dien, jdien.DIENConfig, dien.DIENConfig))):
        jcfg, tcfg = jc(**cfgs[name]), tc(**cfgs[name])
        jp = jax.jit(lambda k: jm.init(k, jcfg))(jax.random.fold_in(key, i))
        like = tm.init(torch.Generator().manual_seed(0), tcfg)
        jmods[name] = (jp, jcfg)
        tmods[name] = (bridge.from_numpy_tree(_np(jp), like=like,
                                              device="cpu"), tcfg)
    jmodels = jeng.CascadeModels(*jmods["dssm"], *jmods["ydnn"],
                                 *jmods["din"], *jmods["dien"])
    tmodels = teng.CascadeModels(*tmods["dssm"], *tmods["ydnn"],
                                 *tmods["din"], *tmods["dien"])
    jchains, tchains = _chains(jac), _chains(tac)
    rkw = dict(n_stages=3, max_models=2, n_scale_groups=4,
               d_context=3 + n_uf + wj.d_latent, d_feature=16, d_hidden=16,
               d_state=8)
    jrp = _np(jax.jit(lambda k: jrm.reward_model_init(
        k, jrm.RewardModelConfig(**rkw)))(jax.random.fold_in(key, 9)))
    jrp["label_norm"] = np.random.default_rng(1).uniform(
        0.5, 2.0, jchains.n_chains).astype(np.float32)
    trp = bridge.from_numpy_tree(
        jrp, like=trm.reward_model_init(torch.Generator(),
                                        trm.RewardModelConfig(**rkw)),
        device="cpu")
    jsrc = jrs.GeneratedSource(JWorld.build(wj), jmodels, jchains,
                               expose=EXPOSE, seed=SEED, chunk=64,
                               item_block=64, workers=1)
    tsrc = trs.GeneratedSource(TWorld.build(TWorldConfig(**WORLD)),
                               tmodels, tchains, expose=EXPOSE, seed=SEED,
                               chunk=64, item_block=64, device="cpu")
    budget = 0.5 * float(jchains.costs.max()) * SIZES[0]
    return dict(jsrc=jsrc, tsrc=tsrc, jrp=jrp, trp=trp,
                jrcfg=jrm.RewardModelConfig(**rkw),
                trcfg=trm.RewardModelConfig(**rkw), budget=budget,
                jchains=jchains)


class _FedRewards(TPipeline):
    """The port's pipeline fed a given reward matrix per window."""

    fed: list = []

    def _rewards(self, ctx):
        return self.fed.pop(0)


def test_pinned_windows_exact(stacks):
    s = stacks
    lam_trace = [0.0, 5e-5, 2e-4]
    jpipe = JPipeline(s["jsrc"].universe,
                      jax.tree_util.tree_map(jnp.asarray, s["jrp"]),
                      s["jrcfg"], s["budget"])
    jst = jrun_stream(jpipe, SIZES, s["jsrc"], lam_trace=lam_trace,
                      prefetch=0)
    plan = jrm.chain_prefix_plan(s["jchains"].chain_idx[:, :, 0])
    sh = jnp.asarray(s["jchains"].scale_multihot)
    reward_fn = jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix_grouped(p, s["jrcfg"], c, sh, plan)))
    tpipe = _FedRewards(s["tsrc"].universe, s["trp"], s["trcfg"],
                        s["budget"], device="cpu")
    downgraded = 0
    for t, (n, jw) in enumerate(zip(SIZES, jst.windows)):
        chunk = s["jsrc"].window(t, n)
        b = len(jw.valid)
        ctx = np.zeros((b, chunk.ctx.shape[1]), np.float32)
        ctx[:n] = chunk.ctx
        tpipe.fed = [torch.tensor(np.asarray(reward_fn(
            jax.tree_util.tree_map(jnp.asarray, s["jrp"]),
            jnp.asarray(ctx))))]
        tables = {k: torch.tensor(np.asarray(v))
                  for k, v in chunk.tables.items()}
        tw = tpipe.serve_window(chunk.ctx, chunk.rows, lam=lam_trace[t],
                                tables=tables)
        np.testing.assert_array_equal(tw.decisions_np, jw.decisions_np)
        np.testing.assert_array_equal(tw.revenue_np, jw.revenue_np)
        assert float(tw.spend) == float(jw.spend)
        assert float(tw.flops) == float(jw.flops)
        assert int(tw.downgraded) == int(jw.downgraded)
        assert len(tw.valid) == b
        assert float(tw.spend) <= s["budget"] + float(
            s["jchains"].costs.max())
        downgraded += int(tw.downgraded)
    assert downgraded > 0  # the pinned zero price made the guard act


def test_raw_windows_agree(stacks):
    s = stacks
    jpipe = JPipeline(s["jsrc"].universe,
                      jax.tree_util.tree_map(jnp.asarray, s["jrp"]),
                      s["jrcfg"], s["budget"])
    jst = jrun_stream(jpipe, SIZES, s["jsrc"], prefetch=0)
    tpipe = TPipeline(s["tsrc"].universe, s["trp"], s["trcfg"],
                      s["budget"], device="cpu")
    tst = trun_stream(tpipe, SIZES, s["tsrc"])
    agree = total = 0
    for jw, tw in zip(jst.windows, tst.windows):
        np.testing.assert_array_equal(tw.valid, jw.valid)
        agree += int((tw.decisions_np == jw.decisions_np).sum())
        total += tw.n_valid
        np.testing.assert_allclose(float(tw.lam_after), float(jw.lam_after),
                                   rtol=1e-3)
        assert float(tw.spend) <= s["budget"] + float(
            s["jchains"].costs.max())
    assert agree / total >= 0.995, agree / total
    assert float(jst.windows[-1].lam_after) > 0  # the price moved
    np.testing.assert_allclose(tst.total_revenue, jst.total_revenue,
                               rtol=0.02)


def test_port_tables_match_jax_tables(stacks):
    """The port's own window (hash world, stage scoring on bridged
    weights, device compaction) reproduces the JAX chunk: contexts
    exactly, tables on all but score near-ties."""
    s = stacks
    jc = s["jsrc"].window(1, 40)
    tc = s["tsrc"].window(1, 40)
    np.testing.assert_array_equal(tc.users, jc.users)
    np.testing.assert_array_equal(tc.ctx, jc.ctx)
    p_j = np.asarray(jc.tables["p"])
    p_t = tc.tables["p"].numpy()
    assert p_t.shape == p_j.shape
    assert (p_t == p_j).mean() >= 0.99
