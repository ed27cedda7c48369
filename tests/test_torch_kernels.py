"""The port's kernels (their plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp references.

Tolerances: truncation is EXACT with 0/1 clicks (integer sums in f32)
and 1e-6 relative with float clicks (summation order); the embedding bag
1e-5 and target attention 2e-5 (f32 sums in another order), as in
tests/test_kernels.py.  The CUDA kernels themselves are held against the
same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cascade_truncate import compact_truncate_revenue
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro.kernels.target_attention import target_attention as jax_ta
from repro_torch.kernels import ops


def _t(x):
    return torch.tensor(np.asarray(x))


def _tables(rng, g_n, u_n, cap, b_n, binary):
    p = np.empty((g_n, u_n, cap), np.int32)
    for g in range(g_n):
        for u in range(u_n):
            count = rng.integers(cap // 2, cap + 1)
            row = rng.permutation(cap)
            p[g, u] = np.where(row < count, row, cap)
    ck = rng.random((g_n, u_n, cap)).astype(np.float32)
    if binary:
        ck = (ck < 0.2).astype(np.float32)
    groups = rng.integers(0, g_n, b_n).astype(np.int32)
    rows = rng.integers(0, u_n, b_n).astype(np.int32)
    n3 = rng.integers(1, cap + 1, b_n).astype(np.int32)
    return p, ck, groups, rows, n3


@pytest.mark.parametrize("g_n,u_n,cap,b_n,expose,binary", [
    (3, 5, 40, 32, 6, True),
    (16, 24, 200, 96, 20, True),
    (2, 7, 33, 17, 40, True),  # expose > cap: everything kept survives
    (3, 5, 40, 32, 6, False),
])
def test_cascade_truncate_matches_pallas_and_xla(g_n, u_n, cap, b_n, expose,
                                                 binary):
    from repro.cascade.engine import _revenue_compact

    rng = np.random.default_rng(cap + b_n)
    args = _tables(rng, g_n, u_n, cap, b_n, binary)
    got = ops.cascade_truncate(*map(_t, args), expose=expose).numpy()
    pallas = np.asarray(compact_truncate_revenue(
        *map(jnp.asarray, args), expose=expose, interpret=True))
    xla = np.asarray(_revenue_compact(*map(jnp.asarray, args),
                                      expose=expose))
    if binary:
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)
    else:
        np.testing.assert_allclose(got, pallas, rtol=1e-6)
        np.testing.assert_allclose(got, xla, rtol=1e-6)


@pytest.mark.parametrize("v,d,b,l", [(100, 32, 8, 4), (1000, 32, 8, 50),
                                     (64, 20, 5, 7)])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_pallas(v, d, b, l, weighted):
    rng = np.random.default_rng(v + l)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32) if weighted else None
    got = ops.embedding_bag(_t(table), _t(ids),
                            None if w is None else _t(w)).numpy()
    want = np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(ids),
                              None if w is None else jnp.asarray(w),
                              interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.embedding_bag_ref(
            table, ids, None if w is None else jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fixed_bag_matches_jax(mode):
    """The YDNN history bag: mean = weighted bag with mask/count."""
    from repro.models.embedding import fixed_bag as jax_fixed_bag
    from repro_torch.models.embedding import fixed_bag

    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 10)).astype(np.int32)
    mask = (np.arange(10)[None] < rng.integers(0, 11, (6, 1))) \
        .astype(np.float32)
    mask[0] = 1.0  # a full bag next to short and empty ones
    got = fixed_bag(_t(table), _t(ids), _t(mask), mode=mode).numpy()
    want = np.asarray(jax_fixed_bag(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(mask), mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _attn_inputs(rng, b, n, t, d, h1, h2):
    q = rng.normal(size=(b, n, d)).astype(np.float32)
    keys = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws.append((0.1 * rng.normal(size=(di, do))).astype(np.float32))
        ws.append((0.1 * rng.normal(size=(do,))).astype(np.float32))
    return q, keys, mask, ws


@pytest.mark.parametrize("b,t,d,h1,h2", [(16, 12, 36, 80, 40),
                                         (50, 100, 36, 80, 40),
                                         (9, 24, 16, 32, 8)])
def test_target_attention_matches_pallas(b, t, d, h1, h2):
    """N = 1: the TPU kernel's own signature."""
    rng = np.random.default_rng(b + t)
    q, keys, mask, ws = _attn_inputs(rng, b, 1, t, d, h1, h2)
    got = ops.target_attention(_t(q), _t(keys), _t(mask),
                               *map(_t, ws))[:, 0].numpy()
    want = np.asarray(jax_ta(jnp.asarray(q[:, 0]), jnp.asarray(keys),
                             jnp.asarray(mask), *map(jnp.asarray, ws),
                             block_b=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,n,t", [(4, 7, 12), (3, 33, 20)])
def test_target_attention_candidates_match_din_pool(b, n, t):
    """N > 1 candidates against per-user keys == the JAX DIN attention
    pool on keys broadcast over the candidates."""
    import jax

    from repro.models.recsys import din as jdin
    cfg = jdin.DINConfig(item_vocab=50, cat_vocab=10, user_vocab=20,
                         seq_len=t, embed_dim=8, attn_hidden=(16, 8))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jdin.init(k, cfg))(jax.random.PRNGKey(1)))
    d = cfg.d_item
    rng = np.random.default_rng(n)
    q = rng.normal(size=(b, n, d)).astype(np.float32)
    keys = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = (rng.random((b, t)) > 0.4).astype(np.float32)
    want = np.asarray(jax.jit(jdin.attention_pool)(
        params, jnp.asarray(q),
        jnp.broadcast_to(jnp.asarray(keys)[:, None], (b, n, t, d)),
        jnp.broadcast_to(jnp.asarray(mask)[:, None], (b, n, t))))
    lay = params["attn"]["layers"]
    ws = [_t(lay[i][k]) for i in range(3) for k in ("w", "b")]
    got = ops.target_attention(_t(q), _t(keys), _t(mask), *ws).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # a candidate list shared by every user (batch stride 0)
    shared = _t(q[0])[None].expand(b, n, d)
    got_s = ops.target_attention(shared, _t(keys), _t(mask), *ws).numpy()
    want_s = ops.target_attention(_t(np.broadcast_to(q[0], (b, n, d))),
                                  _t(keys), _t(mask), *ws).numpy()
    np.testing.assert_array_equal(got_s, want_s)
