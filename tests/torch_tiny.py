"""The tiny materialized serving stack of ``tests/test_spec.py`` built
twice, once from the JAX package and once from the port, on the same
numpy seed: random stage scores and clicks for 40 users and 150 items,
the paper-shaped chain space, and the reward model's weights drawn by
JAX and moved across with ``repro_torch.bridge``.

``pow2=True`` prices the chains in powers of two FLOPs per item, so
every chain cost is an integer and every f32 sum of costs a window makes
is exact in any order: spends and the guard's prefixes then match the
JAX package bit for bit, whatever order either framework sums in.

``FedPipeline`` is the port's pipeline fed the JAX reward matrix of the
window's padded contexts, so decisions at pinned prices can be held to
the JAX package exactly.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.cascade import engine as jeng
from repro.core import action_chain as jac
from repro.core import reward_model as jrm
from repro_torch import bridge
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac
from repro_torch.core import reward_model as trm
from repro_torch.serving.pipeline import ServingPipeline as TPipeline

U, I = 40, 150
PAPER_FLOPS = (13e3, 123e3, 7020e3, 7098e3)  # DSSM, YDNN, DIN, DIEN
POW2_FLOPS = (16.0, 64.0, 512.0, 1024.0)
RCFG = dict(n_stages=3, max_models=2, n_scale_groups=4, d_context=12,
            d_feature=16, d_hidden=16, d_state=8)


def chains(ac, flops):
    n2 = tuple(int(x) for x in np.linspace(0.2 * I, 0.5 * I, 4))
    n3 = tuple(int(x) for x in np.linspace(8, 0.2 * I, 4))
    return ac.generate_action_chains((
        ac.StageSpec("recall", (ac.ModelInstance("DSSM", flops[0]),), (I,),
                     4),
        ac.StageSpec("prerank", (ac.ModelInstance("YDNN", flops[1]),), n2,
                     4),
        ac.StageSpec("rank", (ac.ModelInstance("DIN", flops[2]),
                              ac.ModelInstance("DIEN", flops[3])), n3, 4)))


def build(pow2: bool = True):
    rng = np.random.default_rng(0)
    scores = {k: rng.normal(size=(U, I)).astype(np.float32)
              for k in ("DSSM", "YDNN", "DIN", "DIEN")}
    clicks = (rng.random((U, I)) < 0.15).astype(np.float32)
    flops = POW2_FLOPS if pow2 else PAPER_FLOPS
    jchains, tchains = chains(jac, flops), chains(tac, flops)
    jserver = jeng.CascadeServer(stage_scores=scores, chains=jchains,
                                 clicks=clicks, expose=8)
    tserver = teng.CascadeServer(scores, tchains, clicks, expose=8,
                                 device="cpu")
    jrcfg, trcfg = jrm.RewardModelConfig(**RCFG), trm.RewardModelConfig(
        **RCFG)
    jp = jax.tree_util.tree_map(np.asarray,
                                jrm.reward_model_init(jax.random.PRNGKey(0),
                                                      jrcfg))
    jp = dict(jp, label_norm=np.linspace(1.0, 3.0, jchains.n_chains)
              .astype(np.float32))
    tparams = bridge.from_numpy_tree(
        jp, like=trm.reward_model_init(torch.Generator(), trcfg),
        device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    plan = jrm.chain_prefix_plan(jchains.chain_idx[:, :, 0])
    sh = jnp.asarray(jchains.scale_multihot)
    reward_fn = jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix_grouped(p, jrcfg, c, sh, plan)))
    return SimpleNamespace(scores=scores, clicks=clicks, jchains=jchains,
                           tchains=tchains, jserver=jserver,
                           tserver=tserver, jrcfg=jrcfg, trcfg=trcfg,
                           jparams=jparams, tparams=tparams,
                           reward_fn=reward_fn)


class FedPipeline(TPipeline):
    """The port's pipeline scoring with the JAX reward function."""

    def __init__(self, stack, *a, **kw):
        super().__init__(stack.tserver, stack.tparams, stack.trcfg, *a,
                         device="cpu", **kw)
        self._stack = stack

    @classmethod
    def from_spec(cls, stack, spec, **kw):
        return cls(stack, spec.compile().total_budget, spec=spec, **kw)

    def _rewards(self, ctx):
        st = self._stack
        r = st.reward_fn(st.jparams, jnp.asarray(ctx.cpu().numpy()))
        return torch.from_numpy(np.array(r))


def windows(n_windows=5, n=64, seed=1, d=12):
    """Seeded (ctx, rows) windows over the stack's users."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, d)).astype(np.float32),
             rng.integers(0, U, n)) for _ in range(n_windows)]
