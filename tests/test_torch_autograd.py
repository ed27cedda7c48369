"""The two kernels with a backward: their autograd Functions against
``jax.grad`` of the JAX package's jnp forms, on the CPU.

``ops.target_attention`` and ``ops.embedding_bag`` are autograd
Functions whenever a gradient is needed; on the CPU their backward is
the plain ``ref.*_bwd_ref`` (on the card the backward kernels, held to
the same plain versions in ``tests/test_torch_gpu.py``).  The same numpy
inputs go through ``jax.grad`` of ``din.attention_pool`` (the training
form, N = 1, and the scoring form that broadcasts each user's keys over
N candidates) and of ``embedding.fixed_bag``; every gradient agrees
within 1e-5 (f32 sums in another order).  Inputs whose gradient no path
needs raise.  ``dot_interact``, ``cin_layer`` and ``flash_attention``
are autograd Functions too: their CPU backward equals autograd of the
plain forward (``tests/test_torch_backward_kernels.py`` holds them to
``jax.grad``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import embedding as jemb
from repro.models.recsys import din as jdin
from repro_torch.kernels import ops, ref
from repro_torch.models.embedding import fixed_bag
from repro_torch.models.recsys import din

TOL = dict(rtol=1e-5, atol=1e-5)


def _attn_inputs(seed, b, n, t, d, h1, h2):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = {"q": rng.normal(size=(b, n, d)).astype(f) * 0.5,
         "keys": rng.normal(size=(b, t, d)).astype(f) * 0.5,
         "mask": (np.arange(t)[None] < rng.integers(0, t + 1, (b, 1)))
         .astype(f),
         "g": rng.normal(size=(b, n, d)).astype(f)}
    x["mask"][0] = 1.0
    dims = [4 * d, h1, h2, 1]
    x["attn"] = {"layers": [
        {"w": (rng.normal(size=(dims[i], dims[i + 1])) * 0.3).astype(f),
         "b": (rng.normal(size=dims[i + 1]) * 0.1).astype(f)}
        for i in range(3)]}
    return x


def _jax_grads(x):
    """jax.grad of sum(G * pool) through ``din.attention_pool``: the
    training form for N = 1, the scoring form (each user's keys and mask
    broadcast over its N candidates) otherwise."""
    b, n, d = x["q"].shape
    t = x["keys"].shape[1]

    def loss(attn, q, keys):
        kb = jnp.broadcast_to(keys[:, None], (b, n, t, d))
        mb = jnp.broadcast_to(x["mask"][:, None], (b, n, t))
        pooled = jdin.attention_pool({"attn": attn}, q, kb, mb)
        return jnp.sum(pooled * x["g"])

    return jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, x["attn"]), jnp.asarray(x["q"]),
        jnp.asarray(x["keys"]))


def _port_grads(x):
    t = {k: torch.tensor(x[k], requires_grad=k in ("q", "keys"))
         for k in ("q", "keys", "mask", "g")}
    ws = [torch.tensor(x["attn"]["layers"][i][k], requires_grad=True)
          for i in range(3) for k in ("w", "b")]
    out = ops.target_attention(t["q"], t["keys"], t["mask"], *ws)
    grads = torch.autograd.grad(torch.sum(out * t["g"]),
                                [*ws, t["q"], t["keys"]])
    return grads[:6], grads[6], grads[7]


@pytest.mark.parametrize("shape", [
    (5, 1, 9, 8, 16, 8),  # DIN's training form: one candidate a row
    (4, 3, 7, 6, 10, 5),  # the scoring form: N candidates a user
    (2, 1, 1, 4, 3, 2),  # one history step
])
def test_target_attention_grads_match_jax(shape):
    x = _attn_inputs(0, *shape)
    j_attn, j_q, j_k = _jax_grads(x)
    p_w, p_q, p_k = _port_grads(x)
    np.testing.assert_allclose(p_q.numpy(), np.asarray(j_q), **TOL)
    np.testing.assert_allclose(p_k.numpy(), np.asarray(j_k), **TOL)
    j_w = [j_attn["layers"][i][k] for i in range(3) for k in ("w", "b")]
    for got, want in zip(p_w, j_w):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_din_attention_pool_grads_reach_every_attention_weight():
    """Through ``din.attention_pool`` (q[:, None] to the kernel), as DIN's
    training forward calls it."""
    x = _attn_inputs(1, 6, 1, 8, 8, 16, 8)
    params = {"attn": {"layers": [
        {k: torch.tensor(v, requires_grad=True) for k, v in lay.items()}
        for lay in x["attn"]["layers"]]}}
    q = torch.tensor(x["q"][:, 0], requires_grad=True)
    keys = torch.tensor(x["keys"], requires_grad=True)
    pooled = din.attention_pool(params, q, keys, torch.tensor(x["mask"]))
    leaves = [p for lay in params["attn"]["layers"] for p in lay.values()]
    grads = torch.autograd.grad(
        torch.sum(pooled * torch.tensor(x["g"][:, 0])), [*leaves, q, keys])
    j_attn, j_q, j_k = _jax_grads(x)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(j_q)[:, 0],
                               **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(j_k), **TOL)
    want = [j_attn["layers"][i][k] for i in range(3) for k in ("w", "b")]
    for got, w in zip(grads[:6], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
        assert float(got.abs().max()) > 0


def test_target_attention_bwd_ref_is_autograd_of_the_forward():
    """The plain backward equals autograd through the plain forward."""
    x = _attn_inputs(2, 3, 2, 6, 5, 7, 4)
    args = [torch.tensor(x[k]) for k in ("q", "keys", "mask")] + [
        torch.tensor(x["attn"]["layers"][i][k]) for i in range(3)
        for k in ("w", "b")]
    got = ref.target_attention_bwd_ref(torch.tensor(x["g"]), *args)
    diff = [a.clone().requires_grad_(i != 2) for i, a in enumerate(args)]
    out = ref.target_attention_ref(*diff)
    want = torch.autograd.grad(torch.sum(out * torch.tensor(x["g"])),
                               [a for i, a in enumerate(diff) if i != 2])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,masked", [("mean", True), ("sum", True),
                                         ("sum", False), ("mean", False)])
def test_fixed_bag_table_grad_matches_jax(mode, masked):
    rng = np.random.default_rng(3)
    v, d, b, length = 30, 6, 7, 9
    table = (rng.normal(size=(v, d)) * 0.02).astype(np.float32)
    ids = rng.integers(0, v, (b, length)).astype(np.int32)
    mask = ((np.arange(length)[None] < rng.integers(0, length + 1, (b, 1)))
            .astype(np.float32) if masked else None)
    if masked:
        ids = np.where(mask > 0, ids, 0).astype(np.int32)  # padded ids: 0
    g = rng.normal(size=(b, d)).astype(np.float32)

    def loss(tab):
        out = jemb.fixed_bag(tab, jnp.asarray(ids),
                             None if mask is None else jnp.asarray(mask),
                             mode=mode)
        return jnp.sum(out * g)

    want = jax.grad(loss)(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = fixed_bag(t, torch.tensor(ids),
                    None if mask is None else torch.tensor(mask), mode=mode)
    got, = torch.autograd.grad(torch.sum(out * torch.tensor(g)), [t])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_bwd_ref_is_autograd_of_the_forward():
    gen = torch.Generator().manual_seed(4)
    table = torch.randn(11, 5, generator=gen)
    ids = torch.randint(0, 11, (6, 8), generator=gen)
    w = torch.rand(6, 8, generator=gen)
    g = torch.randn(6, 5, generator=gen)
    got = ref.embedding_bag_bwd_ref(g, ids, w, 11)
    t = table.clone().requires_grad_()
    want, = torch.autograd.grad(
        torch.sum(ref.embedding_bag_ref(t, ids, w) * g), [t])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_without_autograd_the_wrappers_run_as_before():
    """No grad needed (serving, no_grad): the plain forward itself, bit
    for bit, and no Function node on the result."""
    x = _attn_inputs(5, 3, 4, 6, 5, 7, 4)
    args = [torch.tensor(x[k]) for k in ("q", "keys", "mask")] + [
        torch.tensor(x["attn"]["layers"][i][k], requires_grad=True)
        for i in range(3) for k in ("w", "b")]
    with torch.no_grad():
        out = ops.target_attention(*args)
    assert out.grad_fn is None
    assert torch.equal(out, ref.target_attention_ref(*args).detach())
    with_grad = ops.target_attention(*args)
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), out)
    table = torch.randn(9, 4, requires_grad=True)
    ids = torch.randint(0, 9, (3, 5))
    with torch.no_grad():
        bag = ops.embedding_bag(table, ids)
    assert bag.grad_fn is None
    assert torch.equal(ops.embedding_bag(table, ids).detach(), bag)


def test_gradients_no_path_needs_raise():
    x = _attn_inputs(6, 2, 1, 4, 4, 3, 2)
    args = [torch.tensor(x[k]) for k in ("q", "keys")] + [
        torch.tensor(x["mask"], requires_grad=True)] + [
        torch.tensor(x["attn"]["layers"][i][k]) for i in range(3)
        for k in ("w", "b")]
    with pytest.raises(ValueError, match="mask"):
        ops.target_attention(*args)
    table = torch.randn(9, 4, requires_grad=True)
    ids = torch.randint(0, 9, (3, 5))
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(table, ids, torch.rand(3, 5, requires_grad=True))


@pytest.mark.parametrize("name,make", [
    ("dot_interact", lambda dev: (torch.empty(2, 3, 4, device=dev,
                                              requires_grad=True),)),
    ("cin_layer", lambda dev: (torch.empty(5, 6, device=dev,
                                           requires_grad=True),
                               torch.empty(2, 3, 4, device=dev,
                                           requires_grad=True),
                               torch.empty(2, 2, 4, device=dev,
                                           requires_grad=True))),
    ("flash_attention", lambda dev: tuple(
        torch.empty(1, 4, 2, 8, device=dev, requires_grad=True)
        for _ in range(3))),
])
def test_kernels_without_a_backward_raise_off_the_cpu(name, make):
    """The three kernels that had no backward now have one.  Off the CPU
    (the meta device stands for the card: the device check runs before
    anything launches) a call goes to the kernel and raises naming the
    CUDA device, with a gradient needed or not, never falling back to
    autograd of the plain version; on the CPU the Function's backward
    (``ref.*_bwd_ref``) equals autograd of the plain forward to 1e-6 of
    each gradient's largest magnitude, for every input."""
    fn = getattr(ops, name)
    plain = getattr(ref, f"{name}_ref")
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*make("meta"))
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*make("meta"))
    gen = torch.Generator().manual_seed(len(name))
    shapes = [t.shape for t in make("meta")]
    got = [torch.randn(sh, generator=gen, requires_grad=True)
           for sh in shapes]
    want = [t.detach().clone().requires_grad_(True) for t in got]
    out = fn(*got)
    assert out.grad_fn is not None and "Backward" in type(
        out.grad_fn).__name__
    dout = torch.randn(out.shape, generator=gen)
    out.backward(dout)
    plain(*want).backward(dout)
    for g, w in zip(got, want):
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(g.grad, w.grad, rtol=0,
                                   atol=1e-6 * scale)


def test_backward_counters_exist_and_the_cpu_counts_nothing():
    ops.reset_launches()
    x = _attn_inputs(7, 2, 1, 3, 4, 3, 2)
    _port_grads(x)
    assert ops.LAUNCHES["target_attention_bwd"] == 0
    assert ops.LAUNCHES["embedding_bag_bwd"] == 0
    assert set(ops.LAUNCHES) >= {"target_attention_bwd", "embedding_bag_bwd"}
