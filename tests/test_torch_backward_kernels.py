"""The backward kernels of dot interaction, the CIN layer and flash
attention: their plain versions against ``jax.grad`` of the JAX package's
functions, on the CPU.

The Pallas kernels have no backward: the JAX package differentiates plain
jnp forms, so each plain backward (``ref.*_bwd_ref``, what the wrappers
run on the CPU and what the card holds each kernel to) is held to
``jax.grad`` of them on the same numpy inputs: DLRM's interaction oracle
(``dlrm.dot_interact``), the CIN oracle (``xdeepfm.cin_layer``), the
JAX LM's ``_attention`` with its ``_attn_mask`` (causal, window < T,
softcap, GQA 4:2, ragged T) and the kernel-level ``kernels.ref.
flash_attention_ref`` (non-causal, S > T).  Each gradient within 1e-5 of
its largest magnitude in f32 (sums in another order), 2e-2 in bf16
(bf16 rounds at other places in the two frameworks).  Also: the in-place
optimizer updates against the functional ones bit for bit, the
flash backward's refusal of query rows that admit no key, and the index
arithmetic of the dot-interaction backward kernel emulated (the walk that
forms G + G^T, its padded product, the divide-free chunk steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models.recsys import dlrm as jdlrm
from repro.models.recsys import xdeepfm as jxdfm
from repro_torch.kernels import ops, ref
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import micro_value_and_grad, value_and_grad
from repro_torch.tree import leaves

F32_REL, BF16_REL = 1e-5, 2e-2


def _close(got, want, rel):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _grads(fn, args, dout):
    """jax.grad of sum(fn(*args) * dout) in every argument."""
    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * dout)
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("b,f,d", [(16, 27, 64), (5, 13, 7), (3, 2, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dot_interact_bwd_matches_jax_grad(b, f, d, bf16):
    rng = np.random.default_rng(b * f + d)
    x = (0.5 * rng.normal(size=(b, f, d))).astype(np.float32)
    g = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    if bf16:  # round to nearest even in both: the same bits
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
    (want,) = _grads(jdlrm.dot_interact, (jx,), jg.astype(jnp.float32))
    got = ops.dot_interact_bwd(tg, tx)
    assert got.dtype == tx.dtype and want.dtype == jx.dtype
    _close(got, want, BF16_REL if bf16 else F32_REL)


# csrc/dot_interact_bwd.cu's index arithmetic, emulated: the card tests
# hold the kernel itself (tests/test_torch_gpu.py)

def _walk_advance(i, j, n):
    """``Walk::advance``: (i, j) of packed gradient e -> that of e + n,
    past each row of i entries to the next."""
    j += n
    while j >= i:
        j -= i
        i += 1
    return i, j


def _kernel_s(g_row, f):
    """S = G + G^T as the bf16 path forms it in shared memory: a zero
    (16 s, 16 s) buffer, s = ceil(F / 16), into which lane l of the warp
    writes packed gradients l, l + 32, ... at (i, j) and (j, i), walking
    (i, j) 32 gradients at a time from ``Walk(l)``."""
    n = 16 * ((f + 15) // 16)
    s = np.zeros((n, n), np.float32)
    for lane in range(32):
        i, j = _walk_advance(1, lane, 0)
        for e in range(lane, f * (f - 1) // 2, 32):
            s[i, j] = s[j, i] = g_row[e]
            i, j = _walk_advance(i, j, 32)
    return s


@pytest.mark.parametrize("f", [1, 2, 13, 16, 17, 27, 32, 33, 64])
def test_dot_interact_bwd_kernel_walk_forms_g_plus_gt(f):
    """Every packed gradient lands at its np.tril_indices place and the
    mirrored one; the diagonal and the padding past F stay zero."""
    p = f * (f - 1) // 2
    g_row = np.arange(1, p + 1, dtype=np.float32)
    want = np.zeros_like(_kernel_s(g_row, f))
    iu, ju = np.tril_indices(f, k=-1)
    want[iu, ju] = want[ju, iu] = g_row
    np.testing.assert_array_equal(_kernel_s(g_row, f), want)


@pytest.mark.parametrize("b,f,d", [(4, 27, 64), (3, 33, 8), (2, 1, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dot_interact_bwd_kernel_padding_matches_jax_grad(b, f, d, bf16):
    """The bf16 path's product over the padded S, X's rows past F read as
    row F - 1 (S's zero columns cancel them), exact products summed in
    f64 and rounded once, against jax.grad."""
    rng = np.random.default_rng(b + f + d)
    x = (0.5 * rng.normal(size=(b, f, d))).astype(np.float32)
    g = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    if bf16:
        jx, jg = jx.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
        x, g = np.asarray(jx, np.float32), np.asarray(jg, np.float32)
    (want,) = _grads(jdlrm.dot_interact, (jx,), jg.astype(jnp.float32))
    n = 16 * ((f + 15) // 16)
    rows = np.minimum(np.arange(n), f - 1)
    got = np.stack([(_kernel_s(g[k], f).astype(np.float64)
                     @ x[k][rows].astype(np.float64))[:f]
                    for k in range(b)]).astype(np.float32)
    if bf16:
        got = np.asarray(jnp.asarray(got).astype(jnp.bfloat16), np.float32)
    _close(torch.from_numpy(got), want, BF16_REL if bf16 else F32_REL)


@pytest.mark.parametrize("per_row", [1, 2, 3, 8, 16, 31, 32, 33, 64, 70])
def test_dot_interact_bwd_kernel_chunk_steps_as_a_divide(per_row):
    """``Chunk``'s divide-free steps give each lane the (row, item) of
    items lane, lane + 32, ... of rows of per_row items, as divmod does."""
    rows = 27
    for lane in range(32):
        r, c = lane // per_row, lane % per_row
        dr, dc = 32 // per_row, 32 % per_row
        got = []
        while r < rows:
            got.append((r, c))
            r, c = r + dr, c + dc
            if c >= per_row:
                r, c = r + 1, c - per_row
        assert got == [divmod(idx, per_row)
                       for idx in range(lane, rows * per_row, 32)]


@pytest.mark.parametrize("b,hp,m,d,ho", [(6, 39, 39, 10, 200),
                                         (5, 8, 12, 4, 16), (3, 7, 5, 1, 9)])
def test_cin_layer_bwd_matches_jax_grad(b, hp, m, d, ho):
    rng = np.random.default_rng(hp + ho)
    w = (0.05 * rng.normal(size=(ho, hp * m))).astype(np.float32)
    xp = rng.normal(size=(b, hp, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    g = rng.normal(size=(b, ho, d)).astype(np.float32)
    want = _grads(jxdfm.cin_layer, tuple(map(jnp.asarray, (w, xp, x0))),
                  jnp.asarray(g))
    got = ops.cin_layer_bwd(*map(torch.from_numpy, (g, w, xp, x0)))
    for a, b_ in zip(got, want):
        _close(a, b_, F32_REL)


def test_cin_layer_bwd_plain_version_chunks_the_batch():
    """The plain backward forms Z and T a chunk of samples at a time and
    sums dw over the chunks in order: chunking changes only the order of
    f32 sums."""
    gen = torch.Generator().manual_seed(1)
    args = (torch.randn(11, 6, 3, generator=gen),
            torch.randn(6, 5 * 4, generator=gen),
            torch.randn(11, 5, 3, generator=gen),
            torch.randn(11, 4, 3, generator=gen))
    whole = ref.cin_layer_bwd_ref(*args)
    parts = ref.cin_layer_bwd_ref(*args, chunk_elems=2 * 5 * 4 * 3)
    for a, b in zip(parts, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _lm_cfg(h, hk, dh, softcap, scale):
    return jlm.LMConfig(name="attn", n_layers=1, d_model=h * dh, n_heads=h,
                        n_kv_heads=hk, d_head=dh, d_ff=8, vocab=8,
                        padded_vocab=8, attn_softcap=softcap,
                        query_scale=scale, remat=False, fsdp=False)


# (B, T, S, H, Hkv, dh, window, softcap, scale): causal as the LM trains
FLASH_CASES = {
    "causal": (2, 24, 24, 4, 2, 16, -1, None, None),
    "window<T": (1, 40, 40, 4, 2, 8, 9, None, 0.3),
    "softcap": (2, 17, 17, 4, 2, 8, -1, 2.0, 0.5),
    "gqa4:2-window-softcap": (1, 33, 33, 4, 2, 16, 12, 50.0, 1 / 4),
    "ragged T<S": (2, 13, 29, 4, 2, 8, -1, 3.0, None),
    "mha": (1, 21, 21, 3, 3, 12, 5, None, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_bwd_matches_jax_grad(case, bf16):
    """The JAX LM's ``_attention`` under its ``_attn_mask`` (positions
    from 0 for queries and keys), as ``_attn_block`` calls it."""
    b, t, s, h, hk, dh, window, softcap, scale = FLASH_CASES[case]
    rng = np.random.default_rng(t * h + dh)
    q = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    g = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    cfg = _lm_cfg(h, hk, dh, softcap, scale)
    mask = jlm._attn_mask(jnp.arange(t), jnp.arange(s), window)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    tt = torch.bfloat16 if bf16 else torch.float32

    def attn(q_, k_, v_):
        return jlm._attention(cfg, q_, k_, v_, mask).reshape(b, t, h, dh)

    jargs = tuple(jnp.asarray(x).astype(jt) for x in (q, k, v))
    want = _grads(attn, jargs, jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).to(tt) for x in (q, k, v))
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=scale if scale is not None else 1 / dh ** 0.5)
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = ops.flash_attention_bwd(torch.from_numpy(g).to(tt), tq, tk, tv,
                                  out, **kw)
    for a, w_ in zip(got, want):
        assert a.dtype == tt
        _close(a, w_, BF16_REL if bf16 else F32_REL)


def test_flash_attention_bwd_matches_kernel_oracle_noncausal():
    """The kernel-level oracle (``repro/kernels/ref.py``), non-causal with
    a window and S > T."""
    rng = np.random.default_rng(5)
    q, g = (rng.normal(size=(2, 11, 4, 8)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(2, 19, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=False, window=7, softcap=30.0, scale=0.4)
    want = _grads(lambda *a: jref.flash_attention_ref(*a, **kw),
                  tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention_bwd(torch.from_numpy(g), tq, tk, tv,
                                  ops.flash_attention(tq, tk, tv, **kw),
                                  **kw)
    for a, w_ in zip(got, want):
        _close(a, w_, F32_REL)


def test_flash_attention_bwd_refuses_rows_without_keys():
    """A window with T > S + window - 1 leaves the last query rows no key
    (causal or not): the backward refuses it on every device."""
    q = torch.randn(1, 12, 2, 8)
    k = v = torch.randn(1, 4, 2, 8)
    out = ops.flash_attention(q, k, v, window=3)
    with pytest.raises(ValueError, match="admit a key"):
        ops.flash_attention_bwd(out, q, k, v, out, window=3)
    ops.flash_attention_bwd(out, q, k, v, out, window=9)  # T = S + w - 1


def _tree(seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(3, 4, generator=gen).to(dtype),
            "b": [torch.randn(5, generator=gen).to(dtype)]}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_update_in_place_equals_update(wd):
    """``AdamW.update_`` overwrites parameters and moments with
    ``update``'s results, bit for bit, over three steps."""
    o = opt.AdamW(weight_decay=wd)
    params = _tree(0)
    state = o.init(params)
    p2 = {k: (v.clone() if torch.is_tensor(v) else [x.clone() for x in v])
          for k, v in params.items()}
    s2 = o.init(p2)
    for step in range(3):
        grads = _tree(10 + step)
        params, state = o.update(grads, state, params, 3e-4)
        p2_out, s2 = o.update_(grads, s2, p2, 3e-4)
        assert p2_out is p2
        for a, b in zip(leaves((params, state.mu, state.nu)),
                        leaves((p2, s2.mu, s2.nu))):
            assert torch.equal(a, b)
        assert int(s2.step) == step + 1


def test_sgd_in_place_rounds_in_the_parameters_dtype():
    """``sgd_``: p - lr g with lr g and the difference each rounded to the
    parameter's dtype (bf16 here), as the JAX hybrid cells write it."""
    params, grads = _tree(1, torch.bfloat16), _tree(2, torch.bfloat16)
    want = [(p - (g * 0.04)) for p, g in zip(leaves(params), leaves(grads))]
    opt.sgd_(grads, params, 0.04)
    for p, w in zip(leaves(params), want):
        assert p.dtype == torch.bfloat16 and torch.equal(p, w)


def test_micro_value_and_grad_averages_as_the_jax_cell():
    """Two microbatches: loss l_0 / 2 + l_1 / 2 and gradient (g_0 + g_1)
    / 2 of the per-microbatch gradients; one microbatch is
    ``value_and_grad``."""
    params = {"w": torch.randn(4, 3, generator=torch.Generator()
                               .manual_seed(3))}
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(4))

    def loss(p, b):
        return ((b["x"] @ p["w"]) ** 2).mean()

    l, g = micro_value_and_grad(loss, params, {"x": x}, 2)
    l0, g0 = value_and_grad(loss, params, {"x": x[:3]})
    l1, g1 = value_and_grad(loss, params, {"x": x[3:]})
    assert torch.equal(l, l0 / 2 + l1 / 2)
    assert torch.equal(g["w"], (g0["w"] + g1["w"]) / 2)
    l, g = micro_value_and_grad(loss, params, {"x": x}, 1)
    lw, gw = value_and_grad(loss, params, {"x": x})
    assert torch.equal(l, lw) and torch.equal(g["w"], gw["w"])
    assert params["w"].grad is None and not params["w"].requires_grad


def test_micro_value_and_grad_sums_bf16_leaves_in_f32():
    """Over two microbatches a bf16 leaf's gradients are summed in f32 and
    halved there (the JAX trainer's f32 accumulator); an f32 leaf's sum
    stays in place.  One microbatch keeps each leaf's dtype."""
    gen = torch.Generator().manual_seed(5)
    params = {"t": torch.randn(4, 3, generator=gen).to(torch.bfloat16),
              "w": torch.randn(3, generator=gen)}
    x = torch.randn(6, 4, generator=gen).to(torch.bfloat16)

    def loss(p, b):
        return ((b["x"] @ p["t"]).float() @ p["w"]).square().mean()

    l, g = micro_value_and_grad(loss, params, {"x": x}, 2)
    l0, g0 = value_and_grad(loss, params, {"x": x[:3]})
    l1, g1 = value_and_grad(loss, params, {"x": x[3:]})
    assert g0["t"].dtype == torch.bfloat16
    assert g["t"].dtype == torch.float32
    assert torch.equal(g["t"], (g0["t"].float() + g1["t"].float()) / 2)
    assert torch.equal(g["w"], (g0["w"] + g1["w"]) / 2)
    assert torch.equal(l, l0 / 2 + l1 / 2)
