"""Eq. 10 decisions, the downgrade guard and Algorithm 1: JAX vs port.

Decisions are EXACT on identical rewards and price.  The guard is exact
too - decisions, the downgrade count and the spend - on costs that are
small multiples of a power of two, where every f32 prefix sum is exact
so the two frameworks' summation orders cannot differ; on the paper's
FLOPs costs the decisions stay exact and the spend agrees to f32
rounding (1e-6).  Windows that need downgrades pin the price at 0 and
every test asserts the cap.  The lambda trace of ``dual_descent``
agrees within 1e-4 relative: each step sums the window's spend in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import primal_dual as jpd
from repro.serving import guard as jguard
from repro_torch.core import primal_dual as tpd
from repro_torch.serving import guard as tguard


def _window(rng, n, j, pow2_costs):
    rewards = rng.gamma(2.0, 1.0, (n, j)).astype(np.float32)
    if pow2_costs:  # multiples of 16 below 2^16: exact f32 prefix sums
        costs = (16 * rng.integers(1, 4096, j)).astype(np.float32)
    else:  # paper-scale FLOPs
        costs = rng.uniform(5e7, 1.5e9, j).astype(np.float32)
    costs.sort()
    rewards += np.linspace(0, 2, j, dtype=np.float32)  # costlier pays
    return rewards, costs


@pytest.mark.parametrize("lam", [0.0, 1e-10, 1e-9, 3e-4])
def test_allocate_exact(lam):
    rng = np.random.default_rng(0)
    rewards, costs = _window(rng, 300, 64, pow2_costs=False)
    if lam == 3e-4:
        rewards, costs = _window(rng, 300, 64, pow2_costs=True)
    want = np.asarray(jpd.allocate(jnp.asarray(rewards), jnp.asarray(costs),
                                   jnp.float32(lam)))
    got = tpd.allocate(torch.tensor(rewards), torch.tensor(costs),
                       torch.tensor(lam, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("frac,padded", [(0.3, False), (0.6, True),
                                         (0.95, True), (2.0, False)])
def test_downgrade_guard_exact(pow2, frac, padded):
    rng = np.random.default_rng(int(frac * 100) + pow2)
    n, j = 200, 48
    rewards, costs = _window(rng, n, j, pow2)
    # lambda pinned at 0: every request asks for an expensive chain, so
    # a tight budget must downgrade
    dec = np.asarray(jpd.allocate(jnp.asarray(rewards), jnp.asarray(costs),
                                  jnp.float32(0.0)))
    cheap = int(np.argmin(costs))
    valid = np.ones(n, np.float32)
    if padded:
        valid[-37:] = 0.0
    budget = np.float32(frac * float((costs[dec] * valid).sum()))
    jv = jnp.asarray(valid) if padded else None
    jd, jdg, jsp = jax.jit(
        lambda d, c, b, v: jguard.downgrade_guard(d, c, b, cheap, v))(
        jnp.asarray(dec), jnp.asarray(costs), budget, jv)
    td, tdg, tsp = tguard.downgrade_guard(
        torch.tensor(dec), torch.tensor(costs), torch.tensor(budget),
        cheap, torch.tensor(valid) if padded else None)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tdg) == int(jdg)
    if pow2:
        assert float(tsp) == float(jsp)
    else:
        np.testing.assert_allclose(float(tsp), float(jsp), rtol=1e-6)
    n_real = int(valid.sum())
    cap = max(float(budget), n_real * float(costs[cheap]))
    assert float(tsp) <= cap * (1 + 1e-6)
    if frac < 1.0:
        assert int(tdg) > 0
    else:
        assert int(tdg) == 0
    # the host copy agrees with the device guard on unpadded windows
    if not padded:
        hd, hdg, hsp = tguard.downgrade_guard_np(dec, costs.astype(
            np.float64), float(budget), cheap)
        jhd, jhdg, _ = jguard.downgrade_guard_np(dec, costs.astype(
            np.float64), float(budget), cheap)
        np.testing.assert_array_equal(hd, jhd)
        assert hdg == jhdg


@pytest.mark.parametrize("padded", [False, True])
def test_dual_descent_trace(padded):
    rng = np.random.default_rng(7)
    n, j = 256, 64
    rewards, costs = _window(rng, n, j, pow2_costs=False)
    budget = np.float32(0.5 * costs.max() * n * 0.4)
    mask = np.ones(n, np.float32)
    if padded:
        mask[-50:] = 0.0
    m = jnp.asarray(mask) if padded else None
    lam_j, gaps_j = jpd.dual_descent(
        jnp.asarray(rewards), jnp.asarray(costs), budget, jnp.float32(0.0),
        mask=m, max_iters=200)
    lam_t, gaps_t = tpd.dual_descent(
        torch.tensor(rewards), torch.tensor(costs), torch.tensor(budget),
        torch.tensor(0.0), mask=torch.tensor(mask) if padded else None,
        max_iters=200)
    assert float(lam_j) > 0  # the constraint binds
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-4)
    np.testing.assert_allclose(gaps_t.numpy(), np.asarray(gaps_j),
                               rtol=1e-4, atol=1e-4 * float(budget))
    # the price it publishes keeps the window within budget
    used = float(tpd.consumption(torch.tensor(rewards), torch.tensor(costs),
                                 lam_t, torch.tensor(mask)))
    assert used <= 1.05 * float(budget)
