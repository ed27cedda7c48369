"""CompactPlan tables: the port's device compactor against the JAX
package's host builder and its jitted device twin - BITWISE, on the same
float32 stage scores, including score ties and signed zeros.  Also the
chain set and compact layout the tables are built against."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cascade import engine as jeng
from repro.core import action_chain as jac
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac


def _stages(ac, n_items, n2, n3):
    return (
        ac.StageSpec("recall", (ac.ModelInstance("DSSM", 13e3),),
                     (n_items,), 4),
        ac.StageSpec("prerank", (ac.ModelInstance("YDNN", 123e3),), n2, 4),
        ac.StageSpec("rank", (ac.ModelInstance("DIN", 7020e3),
                              ac.ModelInstance("DIEN", 7098e3)), n3, 4),
    )


def test_chain_set_and_layout_match():
    """The paper's chain space: costs, encodings, codes and the compact
    layout maps are identical in both packages."""
    a = jac.generate_action_chains(jac.paper_stage_specs())
    b = tac.generate_action_chains(tac.paper_stage_specs())
    for f in ("chain_idx", "costs", "model_onehot", "scale_multihot",
              "scale_value"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.names == b.names and a.cheapest() == b.cheapest()
    la = jeng.build_compact_layout(a, n_items=4000, expose=20)
    lb = teng.build_compact_layout(b, n_items=4000, expose=20)
    assert la.cap == lb.cap == 200
    np.testing.assert_array_equal(la.group_of_chain, lb.group_of_chain)
    np.testing.assert_array_equal(la.n3_of_chain, lb.n3_of_chain)
    ka, kb = jeng._k3_layout(a, n_items=4000), teng._k3_layout(
        b, n_items=4000)
    np.testing.assert_array_equal(ka["chain_order"], kb["chain_order"])
    assert ka["group_key"] == kb["group_key"]
    assert ka["stage_names"] == kb["stage_names"]


def _scores(rng, u_n, i_n, ties: bool):
    out = {}
    for name in ("DSSM", "YDNN", "DIN", "DIEN"):
        s = rng.normal(size=(u_n, i_n)).astype(np.float32)
        if ties:  # few distinct values, with -0.0 and +0.0 among them
            s = np.round(s * 2.0).astype(np.float32) / 2.0
            s[rng.random(s.shape) < 0.1] = np.float32(-0.0)
        out[name] = s
    return out


@pytest.mark.parametrize("u_n,i_n,ties", [(7, 60, False), (9, 60, True),
                                          (5, 200, True)])
def test_device_compactor_bitwise(u_n, i_n, ties):
    n2 = tuple(int(x) for x in np.linspace(0.2 * i_n, 0.5 * i_n, 4))
    n3 = tuple(sorted({max(4, int(x)) for x in
                       np.linspace(4, 0.2 * i_n, 4)}))
    jchains = jac.generate_action_chains(_stages(jac, i_n, n2, n3))
    tchains = tac.generate_action_chains(_stages(tac, i_n, n2, n3))
    jlay = jeng._k3_layout(jchains, n_items=i_n)
    tlay = teng._k3_layout(tchains, n_items=i_n)
    rng = np.random.default_rng(u_n * i_n)
    scores = _scores(rng, u_n, i_n, ties)
    clicks = (rng.random((u_n, i_n)) < 0.2).astype(np.float32)

    p_h, ck_h, cap = jeng._compact_group_tables(scores, jlay, clicks,
                                                expose=4)
    p_hp, ck_hp, cap_p = teng._compact_group_tables(scores, tlay, clicks,
                                                    expose=4)
    p_j, ck_j = jax.jit(lambda s, c: jeng._compact_group_tables_jax(
        s, jlay, c))({k: jnp.asarray(v) for k, v in scores.items()},
                     jnp.asarray(clicks))
    p_t, ck_t = teng._compact_group_tables_torch(
        {k: torch.tensor(v) for k, v in scores.items()}, tlay,
        torch.tensor(clicks))
    assert cap == cap_p == p_t.shape[2]
    assert p_t.dtype == torch.int32 and ck_t.dtype == torch.float32
    for p, ck in ((p_h, ck_h), (p_hp, ck_hp), (p_j, ck_j)):
        np.testing.assert_array_equal(p_t.numpy(),
                                      np.asarray(p).astype(np.int32))
        np.testing.assert_array_equal(ck_t.numpy(),
                                      np.asarray(ck).astype(np.float32))
