"""The offline experiment's pieces: the port against the JAX package.

The same seeds and numpy inputs go through both packages:
  * the world, the user split and the CTR batches, bit for bit;
  * the reward model's label norm, loss, field-RCE and chunked scoring
    (the training itself: ``tests/test_torch_stage_training.py``);
  * the port's ``precompute_stage_scores`` on JAX-trained models carried
    over (1e-5) and its ``simulate_revenue_matrix`` on JAX's scores
    (exact: revenue counts clicks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiments as JE
from repro.cascade import engine as jengine
from repro.core import action_chain as jac
from repro.core import reward_model as jrm
from repro.data import synthetic as jsyn
from repro_torch import bridge
from repro_torch import experiments as E
from repro_torch.cascade import engine
from repro_torch.cascade.engine import CascadeModels
from repro_torch.core import action_chain as ac
from repro_torch.core import reward_model as rm
from repro_torch.data import synthetic as syn
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = dict(n_users=240, n_items=60, hist_len=8, seed=5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, jax_tree, skip=()):
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax_tree)[0]}
    got = dict(leaves_with_paths(port))
    assert sorted(got) == sorted(want)
    for key in got:
        if key not in skip:
            np.testing.assert_allclose(got[key].detach().numpy(), want[key],
                                       **TOL, err_msg=key)


@pytest.fixture(scope="module")
def worlds():
    return (jsyn.build_world(jsyn.WorldConfig(**WORLD)),
            syn.build_world(syn.WorldConfig(**WORLD)))


@pytest.mark.parametrize("fracs", [jsyn.PAPER_SPLIT,
                                   (0.5, 0.05, 0.25, 0.2)])
def test_world_split_and_batches_bit_equal(worlds, fracs):
    jw, pw = worlds
    for f in ("z_user", "z_item", "activity", "popularity", "item_cat",
              "user_fields", "hist_ids", "hist_mask"):
        np.testing.assert_array_equal(getattr(jw, f), getattr(pw, f))
    js, ps = jsyn.split_users(jw, 7, fracs), syn.split_users(pw, 7, fracs)
    for f in ("cascade_train", "validation", "reward_train", "final_eval"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ps, f))
    jb = jsyn.ctr_batch(jw, js.cascade_train, np.random.default_rng(3), 32)
    pb = syn.ctr_batch(pw, ps.cascade_train, np.random.default_rng(3), 32)
    for k in jb:
        assert jb[k].dtype == pb[k].dtype
        np.testing.assert_array_equal(jb[k], pb[k])
    items = np.tile(np.arange(WORLD["n_items"]), (5, 1))
    np.testing.assert_array_equal(
        jw.sample_clicks(js.final_eval[:5], items, np.random.default_rng(1)),
        pw.sample_clicks(ps.final_eval[:5], items, np.random.default_rng(1)))
    with pytest.raises(ValueError):
        syn.split_users(pw, 7, (0.5, 0.5, 0.5, 0.5))


# -- the reward model's training pieces -------------------------------------


def _chains(pkg, n_items=60, expose=4):
    mod, chain_mod = (JE, jac) if pkg == "jax" else (E, ac)
    cfg = mod.ExperimentConfig(
        world=(jsyn if pkg == "jax" else syn).WorldConfig(**WORLD),
        expose=expose, n_scales=3)
    return cfg, chain_mod.generate_action_chains(mod.scaled_stage_specs(cfg))


@pytest.fixture(scope="module")
def reward_setup():
    _, jchains = _chains("jax")
    _, pchains = _chains("port")
    np.testing.assert_array_equal(jchains.costs, pchains.costs)
    rcfg_kw = dict(n_stages=3, max_models=2, n_scale_groups=4, d_context=23,
                   d_feature=16, d_hidden=16, d_state=8)
    jcfg, pcfg = (jrm.RewardModelConfig(**rcfg_kw),
                  rm.RewardModelConfig(**rcfg_kw))
    jparams = jrm.reward_model_init(jax.random.PRNGKey(33), jcfg)
    pparams = bridge.from_numpy_tree(
        _np(jparams), like=rm.reward_model_init(
            torch.Generator().manual_seed(0), pcfg), device="cpu")
    return jchains, pchains, jcfg, pcfg, jparams, pparams


def test_label_norm_loss_and_field_rce(reward_setup):
    jchains, pchains, jcfg, pcfg, jparams, pparams = reward_setup
    rng = np.random.default_rng(2)
    rev = rng.poisson(1.0, (30, jchains.n_chains)).astype(np.float32)
    rev[:, 0] = 0.0  # a chain that never earns: the norm's floor
    np.testing.assert_array_equal(rm.chain_label_norm(rev),
                                  jrm.chain_label_norm(rev))
    pred = rev + rng.normal(size=rev.shape).astype(np.float32)
    fields = rng.integers(0, 4, rev.size)
    assert rm.field_rce(rev.reshape(-1), pred.reshape(-1), fields) == \
        jrm.field_rce(rev.reshape(-1), pred.reshape(-1), fields)
    j = rng.integers(0, jchains.n_chains, 12)
    batch = {"context": rng.normal(size=(12, 23)).astype(np.float32),
             "model_onehot": jchains.model_onehot[j],
             "scale_multihot": jchains.scale_multihot[j],
             "label": rng.normal(size=12).astype(np.float32),
             "weight": rng.uniform(0, 1, 12).astype(np.float32)}
    for with_w in (True, False):
        b = dict(batch) if with_w else {k: v for k, v in batch.items()
                                        if k != "weight"}
        got = rm.reward_loss(pparams, pcfg,
                             {k: torch.from_numpy(v) for k, v in b.items()})
        want = jrm.reward_loss(jparams, jcfg,
                               {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("n_req,chunk", [(37, 16), (10, 2048)])
def test_reward_matrix_chunked(reward_setup, n_req, chunk):
    jchains, pchains, jcfg, pcfg, jparams, pparams = reward_setup
    ctx = np.random.default_rng(4).normal(size=(n_req, 23)) \
        .astype(np.float32)
    got = rm.reward_matrix_chunked(pparams, pcfg, ctx, pchains.model_onehot,
                                   pchains.scale_multihot, chunk=chunk)
    want = jrm.reward_matrix_chunked(
        jparams, jcfg, ctx, jnp.asarray(jchains.model_onehot),
        jnp.asarray(jchains.scale_multihot), chunk=chunk)
    assert isinstance(got, np.ndarray) and got.shape == (n_req,
                                                         pchains.n_chains)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -- scoring and simulation on JAX-trained models ---------------------------


def test_stage_scores_and_revenue_on_jax_trained_models(worlds):
    jw, pw = worlds
    cfg = JE.ExperimentConfig(world=jsyn.WorldConfig(**WORLD), expose=4,
                              n_scales=3, cascade_steps=4, batch=16)
    users = jsyn.split_users(jw, 1).cascade_train
    jm = JE.train_cascade_models(jw, users, cfg)
    pcfgs = E.stage_configs(pw)
    for jc, pc in zip((jm.dssm_cfg, jm.ydnn_cfg, jm.din_cfg, jm.dien_cfg),
                      pcfgs):
        assert vars(jc) == vars(pc)
    trees = [bridge.from_numpy_tree(_np(p), device="cpu")
             for p in (jm.dssm_params, jm.ydnn_params, jm.din_params,
                       jm.dien_params)]
    pm = CascadeModels(trees[0], pcfgs[0], trees[1], pcfgs[1], trees[2],
                       pcfgs[2], trees[3], pcfgs[3])
    eval_users = jsyn.split_users(jw, 1).final_eval
    j_scores = jengine.precompute_stage_scores(jm, jw, eval_users)
    p_scores = engine.precompute_stage_scores(pm, pw, eval_users,
                                              item_block=16)
    for k in j_scores:
        np.testing.assert_allclose(p_scores[k], j_scores[k], **TOL,
                                   err_msg=k)
    chains = _chains("port", expose=4)[1]
    jchains = _chains("jax", expose=4)[1]
    clicks = jw.sample_clicks(
        eval_users, np.tile(np.arange(WORLD["n_items"]),
                            (len(eval_users), 1)),
        np.random.default_rng(20))
    got = engine.simulate_revenue_matrix(
        {k: np.asarray(v) for k, v in j_scores.items()}, chains, clicks,
        expose=4)
    want = jengine.simulate_revenue_matrix(j_scores, jchains, clicks,
                                           expose=4)
    np.testing.assert_array_equal(got, np.asarray(want))
