"""The experiment's training from the same init: the port against the
JAX package.

``_train_model`` for each stage model and ``train_reward_model`` start
from JAX's init carried over by ``bridge.from_numpy_tree`` and take the
same batches (numpy, bit for bit) in both packages; losses and trained
parameters agree within 1e-5.  On the CPU DIN's and YDNN's gradients
run the plain backward versions that the card's kernels are held to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiments as JE
from repro.core import reward_model as jrm
from repro.data import synthetic as jsyn
from repro.models.recsys import dien as jdien
from repro.models.recsys import din as jdin
from repro.models.recsys import dssm as jdssm
from repro.models.recsys import ydnn as jydnn
from repro_torch import bridge
from repro_torch import experiments as E
from repro_torch.cascade.engine import CascadeModels
from repro_torch.data import synthetic as syn
from repro_torch.models.recsys import dien, din, dssm, ydnn
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


def _chains(pkg):
    mod = JE if pkg == "jax" else E
    cfg = mod.ExperimentConfig(
        world=(jsyn if pkg == "jax" else syn).WorldConfig(**WORLD),
        expose=4, n_scales=3)
    return cfg, mod.generate_action_chains(mod.scaled_stage_specs(cfg))


@pytest.fixture(scope="module")
def worlds():
    return (jsyn.build_world(jsyn.WorldConfig(**WORLD)),
            syn.build_world(syn.WorldConfig(**WORLD)))


def _stage(name, jw, pw):
    """(JAX loss, JAX init, port loss, the port's tree of JAX's init)."""
    pcfgs = dict(zip(("DSSM", "YDNN", "DIN", "DIEN"), E.stage_configs(pw)))
    pcfg = pcfgs[name]
    jmod, pmod = {"DSSM": (jdssm, dssm), "YDNN": (jydnn, ydnn),
                  "DIN": (jdin, din), "DIEN": (jdien, dien)}[name]
    jcfg = getattr(jmod, type(pcfg).__name__)(**vars(pcfg))
    jparams = jmod.init(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.from_numpy_tree(
        _np(jparams), like=pmod.init(torch.Generator().manual_seed(0), pcfg),
        device="cpu")
    bce = (lambda s, y: jnp.mean(jnp.maximum(s, 0) - s * y
                                 + jnp.log1p(jnp.exp(-jnp.abs(s)))))
    # the JAX package's stage losses (closures of train_cascade_models)
    jloss = {
        "DSSM": lambda p, b: bce(jdssm.score(
            p, jcfg, b["user_fields"], jnp.stack([b["item_cat"]], axis=-1)
            [:, None, :])[:, 0] * 6.0, b["label"]),
        "YDNN": lambda p, b: bce(jydnn.score(
            p, jcfg, b["hist_ids"], b["hist_mask"], b["user_fields"],
            b["item_id"][:, None])[:, 0], b["label"]),
        "DIN": lambda p, b: jdin.loss_fn(p, jcfg, b),
        "DIEN": lambda p, b: jdien.loss_fn(p, jcfg, b)}[name]
    ploss = {"DSSM": E.dssm_loss, "YDNN": E.ydnn_loss, "DIN": din.loss_fn,
             "DIEN": dien.loss_fn}[name]
    return jloss, jparams, E._bind_cfg(ploss, pcfg), pparams


@pytest.mark.parametrize("name", ["DSSM", "YDNN", "DIN", "DIEN"])
def test_train_model_matches_jax(worlds, name):
    """25 steps of ``_train_model`` (AdamW, 20 warmup steps, clip 1) from
    JAX's init on the same CTR batches.  DIEN's last attention bias is
    left out: its gradient is exactly zero (its softmax does not see a
    shift), so AdamW moves it by the packages' rounding noise divided by
    its own size; nothing downstream sees it, and DIEN's scores are held
    instead."""
    jw, pw = worlds
    users = jsyn.split_users(jw, 1).cascade_train

    def pipe(world):
        def fn(rng):
            b = (jsyn if world is jw else syn).ctr_batch(world, users, rng,
                                                         16)
            b.pop("users")
            b["hist_mask"][::4, 3:] = 0.0  # some short histories
            return b
        return fn

    jloss, jparams, ploss, pparams = _stage(name, jw, pw)
    j_out, j_losses = JE._train_model(jloss, jparams, pipe(jw), 25, 16, 9)
    p_out, p_losses = E._train_model(ploss, pparams, pipe(pw), 25, 16, 9)
    np.testing.assert_allclose(p_losses, j_losses, **TOL)
    _close(p_out, j_out,
           skip=("attn/layers/2/b",) if name == "DIEN" else ())
    if name == "DIEN":
        rng = np.random.default_rng(0)
        b = pipe(pw)(rng)
        got = dien.forward(p_out, E.stage_configs(pw)[3],
                           {k: torch.from_numpy(v) for k, v in b.items()})
        want = jdien.forward(j_out, jdien.DIENConfig(
            **vars(E.stage_configs(pw)[3])),
            jax.tree_util.tree_map(jnp.asarray, b))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_train_reward_model_matches_jax():
    """``train_reward_model`` (40 steps) from JAX's init on the same
    simulated revenue: the experiments carry only what it reads."""
    jcfg, jchains = _chains("jax")
    pcfg, pchains = _chains("port")
    rng = np.random.default_rng(6)
    rev = rng.poisson(1.5, (50, jchains.n_chains)).astype(np.float32)
    ctx = rng.normal(size=(50, 23)).astype(np.float32)
    common = dict(world=None, split=None, models=None, clicks_eval=None,
                  clicks_reward=None, revenue_eval=None, ctx_eval=None,
                  revenue_reward=rev, ctx_reward=ctx)
    jexp = JE.Experiment(cfg=jcfg, chains=jchains, **common)
    pexp = E.Experiment(cfg=pcfg, chains=pchains, **common)
    # the reward model trains on the cascade models' device: a stand-in
    # holding one CPU tensor where ``models_device`` looks
    pexp.models = CascadeModels(
        {"user_emb": {"table": torch.zeros(1)}}, None, None, None, None,
        None, None, None)
    j_params, j_rcfg = JE.train_reward_model(jexp, steps=40, seed=2)
    init = jrm.reward_model_init(jax.random.PRNGKey(2 + 33), j_rcfg)
    p_params, p_rcfg = E.train_reward_model(
        pexp, steps=40, seed=2,
        init=bridge.from_numpy_tree(_np(init), device="cpu"))
    assert vars(p_rcfg) == vars(j_rcfg)
    _close(p_params, j_params)
    pexp.ctx_eval = ctx[:7]
    np.testing.assert_allclose(
        E.predicted_rewards(pexp, p_params, p_rcfg, ctx[:7]),
        JE.predicted_rewards(jexp, j_params, j_rcfg, ctx[:7]), **TOL)


