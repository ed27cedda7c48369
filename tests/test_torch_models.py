"""Stage models and the reward model: JAX vs the port on bridged weights.

JAX inits the weights; ``repro_torch.bridge`` carries the numpy tree
over (checking every key and shape against the port's own init); the
same numpy inputs go through both.  Float chains agree within 1e-5
(rel and abs): f32 matmuls and reductions run in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import dien as jdien
from repro.models.recsys import din as jdin
from repro.models.recsys import dssm as jdssm
from repro.models.recsys import ydnn as jydnn
from repro_torch import bridge
from repro_torch.models.recsys import dien, din, dssm, ydnn

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, T, V, C, F = 5, 7, 9, 60, 6, 3


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _bridge(jparams, port_init, cfg):
    like = port_init(torch.Generator().manual_seed(0), cfg)
    return bridge.from_numpy_tree(_np_tree(jparams), like=like,
                                  device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    b = {
        "user_fields": rng.integers(0, 12, (B, F)).astype(np.int32),
        "hist_ids": rng.integers(0, V, (B, T)).astype(np.int32),
        "hist_cats": rng.integers(0, C, (B, T)).astype(np.int32),
        "hist_mask": (np.arange(T)[None] < rng.integers(0, T + 1, (B, 1)))
        .astype(np.float32),
        "cand_ids": rng.integers(0, V, (B, N)).astype(np.int32),
        "cand_cats": rng.integers(0, C, (B, N)).astype(np.int32),
    }
    b["hist_mask"][0] = 1.0
    return b


def _split(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    return jb, tb


def test_dssm_score(batch):
    cfg = jdssm.DSSMConfig(user_vocab=12, item_vocab=V, n_user_fields=F,
                           n_item_fields=2, embed_dim=6, hidden=(16, 8),
                           d_out=4)
    jp = jax.jit(lambda k: jdssm.init(k, cfg))(jax.random.PRNGKey(1))
    tp = _bridge(jp, dssm.init, dssm.DSSMConfig(**cfg.__dict__))
    items = np.stack([batch["cand_ids"], batch["cand_cats"]], -1)
    want = jax.jit(lambda p, u, i: jdssm.score(p, cfg, u, i))(
        jp, jnp.asarray(batch["user_fields"]), jnp.asarray(items))
    got = dssm.score(tp, cfg, torch.tensor(batch["user_fields"]),
                     torch.tensor(items))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ydnn_score(batch):
    cfg = jydnn.YDNNConfig(item_vocab=V, n_user_fields=F, user_vocab=12,
                           hist_len=T, embed_dim=8, hidden=(16, 8), d_out=6)
    jp = jax.jit(lambda k: jydnn.init(k, cfg))(jax.random.PRNGKey(2))
    tp = _bridge(jp, ydnn.init, ydnn.YDNNConfig(**cfg.__dict__))
    jb, tb = _split(batch)
    want = jax.jit(lambda p, b: jydnn.score(
        p, cfg, b["hist_ids"], b["hist_mask"], b["user_fields"],
        b["cand_ids"]))(jp, jb)
    got = ydnn.score(tp, cfg, tb["hist_ids"], tb["hist_mask"],
                     tb["user_fields"], tb["cand_ids"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_rank_model_score(batch, name):
    jmod, tmod = (jdin, din) if name == "DIN" else (jdien, dien)
    kw = dict(item_vocab=V, cat_vocab=C, user_vocab=12, n_user_fields=F,
              embed_dim=4, seq_len=T, attn_hidden=(12, 6),
              mlp_hidden=(10, 6))
    jcfg = (jdin.DINConfig if name == "DIN" else jdien.DIENConfig)(**kw)
    tcfg = (din.DINConfig if name == "DIN" else dien.DIENConfig)(**kw)
    jp = jax.jit(lambda k: jmod.init(k, jcfg))(jax.random.PRNGKey(3))
    tp = _bridge(jp, tmod.init, tcfg)
    jb, tb = _split(batch)
    want = jax.jit(lambda p, b: jmod.score(p, jcfg, b, b["cand_ids"],
                                           b["cand_cats"]))(jp, jb)
    got = tmod.score(tp, tcfg, tb, tb["cand_ids"], tb["cand_cats"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a candidate list shared by every user (batch stride 0) scores the
    # same as the materialised list
    ids0 = tb["cand_ids"][0][None].expand(B, N)
    cats0 = tb["cand_cats"][0][None].expand(B, N)
    got_s = tmod.score(tp, tcfg, tb, ids0, cats0)
    want_s = tmod.score(tp, tcfg, tb, ids0.contiguous(), cats0.contiguous())
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), **TOL)
    # pointwise forward (one target item per request)
    jb1 = dict(jb, item_id=jb["cand_ids"][:, 0],
               item_cat=jb["cand_cats"][:, 0])
    tb1 = dict(tb, item_id=tb["cand_ids"][:, 0],
               item_cat=tb["cand_cats"][:, 0])
    np.testing.assert_allclose(
        tmod.forward(tp, tcfg, tb1).numpy(),
        np.asarray(jax.jit(lambda p, b: jmod.forward(p, jcfg, b))(jp, jb1)),
        **TOL)


# -- reward model -----------------------------------------------------------


@pytest.fixture(scope="module")
def reward_setup():
    from repro.core.action_chain import (ModelInstance, StageSpec,
                                         generate_action_chains)
    from repro.core.reward_model import RewardModelConfig as JCfg
    from repro.core.reward_model import reward_model_init as jinit
    from repro_torch.core.reward_model import RewardModelConfig
    from repro_torch.core.reward_model import reward_model_init

    chains = generate_action_chains((
        StageSpec("recall", (ModelInstance("DSSM", 13e3),), (200,), 4),
        StageSpec("prerank", (ModelInstance("YDNN", 123e3),),
                  (40, 60, 80, 100), 4),
        StageSpec("rank", (ModelInstance("DIN", 7020e3),
                           ModelInstance("DIEN", 7098e3)),
                  (8, 16, 24, 40), 4)))
    kw = dict(n_stages=3, max_models=2, n_scale_groups=4, d_context=23,
              d_feature=16, d_hidden=16, d_state=8)
    jp = _np_tree(jax.jit(lambda k: jinit(k, JCfg(**kw)))(
        jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    jp["label_norm"] = rng.uniform(0.5, 3.0, chains.n_chains) \
        .astype(np.float32)
    like = reward_model_init(torch.Generator().manual_seed(0),
                             RewardModelConfig(**kw))
    tp = bridge.from_numpy_tree(jp, like=like, device="cpu")
    ctx = rng.normal(size=(33, 23)).astype(np.float32)
    return chains, JCfg(**kw), RewardModelConfig(**kw), jp, tp, ctx


def test_reward_matrix_grouped(reward_setup):
    """Grouped scoring (the serving hot path) within 1e-5 of the JAX
    grouped and full matrices - not bitwise (grouped vs full is not
    bitwise even inside the JAX package on this toolchain)."""
    from repro.core import reward_model as jrm
    from repro_torch.core import reward_model as trm

    chains, jcfg, tcfg, jp, tp, ctx = reward_setup
    plan_j = jrm.chain_prefix_plan(chains.chain_idx[:, :, 0])
    plan_t = trm.chain_prefix_plan(chains.chain_idx[:, :, 0])
    for (a, b, c), (x, y, z) in zip(plan_j, plan_t):
        for u, v in ((a, x), (b, y), (c, z)):
            np.testing.assert_array_equal(u, v)
    jpj = jax.tree_util.tree_map(jnp.asarray, jp)
    sh = chains.scale_multihot
    want = np.asarray(jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix_grouped(p, jcfg, c, jnp.asarray(sh),
                                     plan_j)))(jpj, jnp.asarray(ctx)))
    full = np.asarray(jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix(p, jcfg, c, jnp.asarray(chains.model_onehot),
                             jnp.asarray(sh))))(jpj, jnp.asarray(ctx)))
    got = trm.denormalize_rewards(tp, trm.reward_matrix_grouped(
        tp, tcfg, torch.tensor(ctx), torch.tensor(sh), plan_t)).numpy()
    got_full = trm.denormalize_rewards(tp, trm.reward_matrix(
        tp, tcfg, torch.tensor(ctx), torch.tensor(chains.model_onehot),
        torch.tensor(sh))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(got_full, full, **TOL)


def test_reward_apply(reward_setup):
    from repro.core import reward_model as jrm
    from repro_torch.core import reward_model as trm

    chains, jcfg, tcfg, jp, tp, ctx = reward_setup
    j = np.arange(len(ctx)) % chains.n_chains
    mo, sh = chains.model_onehot[j], chains.scale_multihot[j]
    want = jax.jit(lambda p, c, m, s: jrm.reward_apply(p, jcfg, c, m, s))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(ctx),
        jnp.asarray(mo), jnp.asarray(sh))
    got = trm.reward_apply(tp, tcfg, torch.tensor(ctx), torch.tensor(mo),
                           torch.tensor(sh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_rejects_mismatched_trees():
    cfg = din.DINConfig(item_vocab=V, cat_vocab=C, user_vocab=12,
                        embed_dim=4, seq_len=T, attn_hidden=(12, 6),
                        mlp_hidden=(10, 6))
    like = din.init(torch.Generator().manual_seed(0), cfg)
    jp = _np_tree(jdin.init(jax.random.PRNGKey(0), jdin.DINConfig(
        item_vocab=V + 1, cat_vocab=C, user_vocab=12, embed_dim=4,
        seq_len=T, attn_hidden=(12, 6), mlp_hidden=(10, 6))))
    with pytest.raises(ValueError, match="item_emb/table: shape"):
        bridge.from_numpy_tree(jp, like=like, device="cpu")
    del jp["prelu1"]
    with pytest.raises(ValueError, match="keys"):
        bridge.from_numpy_tree(jp, like=like, device="cpu")


def test_bridge_loads_checkpoint(tmp_path, reward_setup):
    """The framework-neutral checkpoint (arrays.npz + manifest.json)
    that repro/training/checkpoint.py writes loads into the port."""
    from repro.training import checkpoint

    chains, jcfg, tcfg, jp, tp, ctx = reward_setup
    models = {"din": _np_tree(jdin.init(jax.random.PRNGKey(6), jdin.DINConfig(
        item_vocab=V, cat_vocab=C, user_vocab=12, embed_dim=4, seq_len=T,
        attn_hidden=(12, 6), mlp_hidden=(10, 6)))), "reward": jp}
    checkpoint.save(str(tmp_path), 3, models)
    tree, manifest = bridge.load_checkpoint(str(tmp_path))
    assert manifest["step"] == 3
    flat_a = jax.tree_util.tree_leaves_with_path(models)
    flat_b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    loaded = bridge.from_numpy_tree(tree["reward"], like=tp, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(
            jax.tree_util.tree_map(np.asarray, tp))),
            jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, loaded))):
        np.testing.assert_array_equal(a, b)
