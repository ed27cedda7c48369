"""The serving stack of ``tests/conftest.py``'s ``system_exp`` and
``system_reward`` (the JAX package's trained experiment and reward
model), carried over to the port: the same stage scores and clicks make
both packages' ``CascadeServer``s, the chains come from the port's own
``scaled_stage_specs`` of the same config, and the reward model's
weights cross through ``repro_torch.bridge``.

``FedPipeline`` is the port's pipeline scoring with the JAX reward
function, so decisions can be held to the JAX package's exactly;
``jax_scorer`` is that function on its own.  ``one_thread`` is the
fixture of the tests that run the serving CLI.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cascade import engine as jeng
from repro.core import reward_model as jrm
from repro_torch import bridge
from repro_torch import experiments as E
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac
from repro_torch.core import reward_model as trm
from repro_torch.data import synthetic as tsyn
from repro_torch.serving.pipeline import ServingPipeline as TPipeline


@pytest.fixture()
def one_thread():
    """The CLI trains its stack (or loads it from the experiment cache):
    thousands of small ops, which many torch threads a test process make
    several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg) -> E.ExperimentConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "world"}
    return E.ExperimentConfig(
        world=tsyn.WorldConfig(**dataclasses.asdict(jcfg.world)), **fields)


def jax_scorer(jchains, jrcfg):
    """The JAX reward function of the fused pass: (params, ctx) -> (n, J)
    de-normalized grouped rewards."""
    plan = jrm.chain_prefix_plan(jchains.chain_idx[:, :, 0])
    sh = jnp.asarray(jchains.scale_multihot)
    return jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix_grouped(p, jrcfg, c, sh, plan)))


def carry(jexp, jreward) -> SimpleNamespace:
    jparams, jrcfg = jreward
    scores = {k: np.asarray(v) for k, v in jeng.precompute_stage_scores(
        jexp.models, jexp.world, jexp.split.final_eval).items()}
    jserver = jeng.CascadeServer(stage_scores=scores, chains=jexp.chains,
                                 clicks=jexp.clicks_eval,
                                 expose=jexp.cfg.expose)
    pcfg = port_config(jexp.cfg)
    tchains = tac.generate_action_chains(E.scaled_stage_specs(pcfg))
    np.testing.assert_array_equal(tchains.costs, jexp.chains.costs)
    tserver = teng.CascadeServer(scores, tchains, jexp.clicks_eval,
                                 expose=jexp.cfg.expose, device="cpu")
    trcfg = trm.RewardModelConfig(**dataclasses.asdict(jrcfg))
    jnp_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = bridge.from_numpy_tree(
        jnp_params, like=trm.reward_model_init(torch.Generator(), trcfg),
        device="cpu")
    texp = SimpleNamespace(cfg=pcfg, chains=tchains,
                           ctx_eval=np.asarray(jexp.ctx_eval))
    return SimpleNamespace(
        jexp=jexp, jserver=jserver, jparams=jparams, jrcfg=jrcfg,
        texp=texp, tserver=tserver, tparams=tparams, trcfg=trcfg,
        tchains=tchains, scores=scores,
        reward_fn=jax_scorer(jexp.chains, jrcfg))


class FedPipeline(TPipeline):
    """The port's pipeline scoring with the JAX reward function."""

    def __init__(self, sys, server, *a, **kw):
        super().__init__(server, sys.tparams, sys.trcfg, *a, device="cpu",
                         **kw)
        self._sys = sys

    @classmethod
    def from_spec(cls, sys, server, spec, **kw):
        return cls(sys, server, spec.compile().total_budget, spec=spec,
                   **kw)

    def _rewards(self, ctx):
        s = self._sys
        r = s.reward_fn(s.jparams, jnp.asarray(ctx.cpu().numpy()))
        return torch.from_numpy(np.array(r))
