"""The arithmetic of the port's 3xTF32 kernels, emulated on the CPU.

``kernels/csrc/cin.cu``, ``target_attention.cu``, ``flash_attention.cu``
(f32) and ``dot_interact.cu`` (its f32 path) compute their f32 products
on the tensor cores as three TF32 products: each operand x is split into
hi = tf32(x) and lo = tf32(x - hi), rounded to nearest (ties away from
zero) at 13 dropped mantissa bits, as ``cvt.rna.tf32.f32`` does, and
a_lo b_hi + a_hi b_lo + a_hi b_hi is summed.  Target attention first
splits W1's row blocks: feat W1 = q (Wq + Wd) + k (Wk - Wd) + (q*k) Wp,
with only (q*k) Wp and . W2 on the tensor cores.  Flash attention takes
Q K^T and P V that way, with the softmax in f32 between them; dot
interaction takes the Gram matrix X X^T.  Target attention's backward
(``target_attention_bwd.cu``) takes X = [k, q*k] against Wx = [Wk - Wd;
Wp], the second layer, dz2 W2^T, dz1 Wx^T and the weight gradients
X^T dz1 and a1^T dz2 that way; it is held against ``jax.grad`` of the
JAX attention pool at the card's 5e-5 of each gradient's largest
magnitude.

Here that arithmetic is written in plain torch (products of TF32 values
are exact in f32; the sums are f32) and held, at the cards' gates (CIN
1e-4, target attention, flash attention and dot interaction 2e-5),
against the JAX package's Pallas kernels in interpret mode and against
the port's plain versions.  One case per kernel shows that a single TF32
pass misses its gate: the reason for three.  The emulation lives here
only; nothing on the main path uses it.

The emulation models one pass whose sums round to nearest.  The tensor
cores accumulate with less than that, which is why the kernels promote
each short tensor-core chain into an f32 sum; that the promotion
intervals hold the gates is shown on the card, by ``test_torch_gpu.py``'s
``test_cin_kernel_stages_x_prev_in_chunks`` (K = 7,800 in one part) and
``test_flash_attention_f32_long_chain`` (T = S = 8,192, dh = 256), not
here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.dot_interact import dot_interact as jax_dot
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.target_attention import target_attention as jax_ta
from repro.models.recsys import din as jdin
from repro_torch.kernels import ref

CIN_TOL = dict(rtol=1e-4, atol=1e-4)
TA_TOL = dict(rtol=2e-5, atol=2e-5)
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # flash attention, dot interaction


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, through the int32 view: add half of the dropped 13 bits'
    range to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, mode):
    """a @ b over the last two dimensions: in f32, as one TF32 pass, or as
    3xTF32 (the small terms first, each product's sum in f32)."""
    if mode == "f32":
        return a @ b
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "1xtf32":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def cin_emulated(w, x_prev, x0, mode):
    """out[b, o, d] = sum_k w[o, k] z[b, k, d], z formed in f32 and the
    product taken as the kernel does."""
    b, hp, d = x_prev.shape
    z = (x_prev[:, :, None, :] * x0[:, None, :, :]).reshape(b, -1, d)
    return mm(w, z, mode)  # (H_out, K) @ (B, K, D) -> (B, H_out, D)


def ta_emulated(q, keys, mask, w1, b1, w2, b2, w3, b3, mode):
    """The kernel's split form: Aq and Ak + b1 in f32, (q*k) Wp and
    . W2 as ``mode`` products, the rest in f32."""
    d = q.shape[-1]
    wq, wk, wd, wp = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    aq = q @ (wq + wd)  # (B, N, h1), once per candidate
    ak = keys @ (wk - wd) + b1  # (B, T, h1), once per step
    qk = q[:, :, None, :] * keys[:, None, :, :]  # (B, N, T, d)
    h = torch.sigmoid(aq[:, :, None] + ak[:, None] + mm(qk, wp, mode))
    h = torch.sigmoid(b2 + mm(h, w2, mode))
    w = (h @ w3 + b3)[..., 0] * mask[:, None, :]
    return torch.einsum("bnt,btd->bnd", w, keys)


def ta_bwd_emulated(dout, q, keys, mask, w1, b1, w2, b2, w3, b3, mode):
    """The backward kernel's algebra (csrc/target_attention_bwd.cu): with
    X = [k, q*k] and Wx = [Wk - Wd; Wp], z1 = Aq + X Wx (Aq = q (Wq + Wd)
    + b1 once a candidate), z2 = a1 W2 + b2, dz1 = (dz2 W2^T) . a1 (1 -
    a1) and P = dz1 Wx^T as ``mode`` products; dq = sum_t k . P2 +
    s (Wq + Wd)^T with s = sum_t dz1; the weight gradients X^T dz1 and
    a1^T dz2 as ``mode`` products over all pairs, dWq = sum_n q (x) s and
    dWd = dWq - dWk; the rest in f32."""
    b, n, d = q.shape
    t = keys.shape[1]
    h1 = w1.shape[1]
    wq, wk, wd, wp = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    wx = torch.cat([wk - wd, wp])  # (2d, h1)
    aq = q @ (wq + wd) + b1  # (B, N, h1), once per candidate
    kb = keys[:, None].expand(b, n, t, d)
    qb = q[:, :, None].expand(b, n, t, d)
    x = torch.cat([kb, qb * kb], dim=-1)  # (B, N, T, 2d)
    a1 = torch.sigmoid(aq[:, :, None] + mm(x, wx, mode))
    a2 = torch.sigmoid(b2 + mm(a1, w2, mode))
    m = mask[:, None, :]
    w = (a2 @ w3 + b3)[..., 0] * m
    ds = m * torch.einsum("bnd,btd->bnt", dout, keys)
    dz2 = ds[..., None] * w3[:, 0] * a2 * (1 - a2)
    dz1 = mm(dz2, w2.T, mode) * a1 * (1 - a1)
    p1, p2 = mm(dz1, wx.T, mode).split(d, dim=-1)
    dk = (p1 + qb * p2 + w[..., None] * dout[:, :, None]).sum(dim=1)
    s = dz1.sum(dim=2)  # (B, N, h1)
    dq = (kb * p2).sum(dim=2) + s @ (wq + wd).T
    gw = mm(x.reshape(-1, 2 * d).T, dz1.reshape(-1, h1), mode)
    dwk, dwp = gw[:d], gw[d:]
    dwq = q.reshape(-1, d).T @ s.reshape(-1, h1)
    dw1 = torch.cat([dwq, dwk, dwq - dwk, dwp])
    dw2 = mm(a1.reshape(-1, h1).T, dz2.reshape(-1, w2.shape[1]), mode)
    dw3 = (ds[..., None] * a2).reshape(-1, w2.shape[1]).sum(dim=0)
    return (dq, dk, dw1, s.sum(dim=(0, 1)), dw2, dz2.sum(dim=(0, 1, 2)),
            dw3[:, None], ds.sum().reshape(1))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_tf32_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)  # ties go away from zero
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi - r).abs() <= r.abs() * 2.0 ** -11).all()
    # hi + lo keeps 21 or more of the 24 bits
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= r.abs().double() * 2.0 ** -21).all()


def _cin_inputs(hp, b=8, m=39, d=10, ho=200):
    rng = np.random.default_rng(hp)
    k = hp * m
    w = (np.sqrt(2.0 / (ho + k)) * rng.normal(size=(ho, k))).astype(np.float32)
    xp = rng.normal(size=(b, hp, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    return w, xp, x0


@pytest.mark.parametrize("hp", [39, 200])  # K = 1,521 and 7,800
def test_cin_3xtf32_meets_the_gate(hp):
    w, xp, x0 = _cin_inputs(hp)
    got = cin_emulated(*map(_t, (w, xp, x0)), "3xtf32").numpy()
    pallas = np.asarray(jops.cin_layer(*map(jnp.asarray, (w, xp, x0)),
                                       interpret=True))
    plain = ref.cin_layer_ref(*map(_t, (w, xp, x0))).numpy()
    np.testing.assert_allclose(got, pallas, **CIN_TOL)
    np.testing.assert_allclose(got, plain, **CIN_TOL)


def test_cin_one_tf32_pass_misses_the_gate():
    w, xp, x0 = _cin_inputs(200)
    one = cin_emulated(*map(_t, (w, xp, x0)), "1xtf32").numpy()
    plain = ref.cin_layer_ref(*map(_t, (w, xp, x0))).numpy()
    past = np.abs(one - plain) > CIN_TOL["atol"] + CIN_TOL["rtol"] * \
        np.abs(plain)
    assert past.sum() > 100


def _ta_inputs(shared, b=6, n=96, t=100, d=36, h1=80, h2=40):
    rng = np.random.default_rng(7 + shared)
    qn = (0.3 * rng.normal(size=(1 if shared else b, n, d))).astype(np.float32)
    q = np.broadcast_to(qn, (b, n, d))
    keys = (0.3 * rng.normal(size=(b, t, d))).astype(np.float32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    mask[1] = 0.0  # a user with no history
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws.append((di ** -0.5 * rng.normal(size=(di, do))).astype(np.float32))
        ws.append((0.1 * rng.normal(size=(do,))).astype(np.float32))
    return q, keys, mask, ws


def _ta_pallas(q, keys, mask, ws):
    """The TPU kernel takes one query a row: each (user, candidate) pair
    is a row with the user's keys."""
    b, n, d = q.shape
    keys, mask = (jnp.asarray(np.repeat(x, n, axis=0)) for x in (keys, mask))
    out = jax_ta(jnp.asarray(q.reshape(b * n, d)), keys, mask,
                 *map(jnp.asarray, ws), block_b=128, interpret=True)
    return np.asarray(out).reshape(b, n, d)


@pytest.mark.parametrize("mode", ["f32", "3xtf32"])
@pytest.mark.parametrize("shared", [True, False])
def test_target_attention_split_meets_the_gate(mode, shared):
    """The W1 split, in f32 and with 3xTF32 products, for a candidate list
    shared by every user and for per-user candidates."""
    q, keys, mask, ws = _ta_inputs(shared)
    b, n, d = q.shape  # a shared list goes in with batch stride 0
    args = (_t(q[0])[None].expand(b, n, d) if shared else _t(q), _t(keys),
            _t(mask), *map(_t, ws))
    got = ta_emulated(*args, mode).numpy()
    np.testing.assert_allclose(got, _ta_pallas(q, keys, mask, ws), **TA_TOL)
    np.testing.assert_allclose(got, ref.target_attention_ref(*args).numpy(),
                               **TA_TOL)
    assert not got[1].any()  # the masked-out user pools nothing


def test_target_attention_one_tf32_pass_misses_the_gate():
    q, keys, mask, ws = _ta_inputs(True)
    args = (_t(q), _t(keys), _t(mask), *map(_t, ws))
    one = ta_emulated(*args, "1xtf32").numpy()
    plain = ref.target_attention_ref(*args).numpy()
    past = np.abs(one - plain) > TA_TOL["atol"] + TA_TOL["rtol"] * \
        np.abs(plain)
    assert past.sum() > 100


def flash_emulated(q, k, v, mode, *, causal=True, window=-1, softcap=None,
                   scale=None):
    """Q K^T and P V as ``mode`` products, scale, softcap, masks and the
    softmax in f32, as the kernel orders them."""
    b, t, h, dh = q.shape
    s, hk = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, t, hk, h // hk, dh).permute(0, 2, 3, 1, 4)
    logits = mm(qg, k.permute(0, 2, 3, 1)[:, :, None], mode) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(t)[:, None]
    k_pos = torch.arange(s)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    p = torch.softmax(torch.where(mask, logits, torch.tensor(-1e30)), -1)
    out = mm(p, v.permute(0, 2, 1, 3)[:, :, None], mode)  # (b, hk, g, t, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)


FLASH_CASES = {  # (b, t, s, h, hk, dh), keywords
    "dh16-softcap": ((1, 96, 96, 4, 2, 16), dict(softcap=50.0)),
    "dh256-window-softcap": ((1, 80, 80, 4, 2, 256),
                             dict(window=24, softcap=50.0, scale=1 / 16)),
    "dh16-noncausal-ragged": ((2, 70, 100, 2, 1, 16),
                              dict(causal=False, window=40)),
}


def _flash_inputs(shape):
    rng = np.random.default_rng(sum(shape))
    b, t, s, h, hk, dh = shape
    return [rng.normal(size=x).astype(np.float32)
            for x in ((b, t, h, dh), (b, s, hk, dh), (b, s, hk, dh))]


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_3xtf32_meets_the_gate(case):
    shape, kw = FLASH_CASES[case]
    x = _flash_inputs(shape)
    got = flash_emulated(*map(_t, x), "3xtf32", **kw).numpy()
    pallas = np.asarray(jax_flash(*map(jnp.asarray, x), block_q=64,
                                  block_kv=64, interpret=True, **kw))
    plain = ref.flash_attention_ref(*map(_t, x), **kw).numpy()
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, plain, **F32_TOL)


def _dot_inputs(b, f, d):
    rng = np.random.default_rng(f * d)
    return (0.3 * rng.normal(size=(b, f, d))).astype(np.float32)


def dot_emulated(x, mode):
    """The Gram matrix X X^T as ``mode`` products, its strictly lower
    triangle in ``np.tril_indices`` order."""
    f = x.shape[1]
    z = mm(x, x.mT, mode)
    iu, ju = np.tril_indices(f, k=-1)
    return z[:, iu, ju]


@pytest.mark.parametrize("b,f,d", [(9, 27, 64), (5, 13, 63)])
def test_dot_interact_3xtf32_meets_the_gate(b, f, d):
    x = _dot_inputs(b, f, d)
    got = dot_emulated(_t(x), "3xtf32").numpy()
    pallas = np.asarray(jax_dot(jnp.asarray(x), block_b=8, interpret=True))
    plain = ref.dot_interact_ref(_t(x)).numpy()
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, plain, **F32_TOL)


@pytest.mark.parametrize("kernel", ["flash_attention", "dot_interact"])
def test_one_tf32_pass_misses_the_f32_gate(kernel):
    if kernel == "flash_attention":
        shape, kw = FLASH_CASES["dh256-window-softcap"]
        x = list(map(_t, _flash_inputs(shape)))
        one = flash_emulated(*x, "1xtf32", **kw).numpy()
        plain = ref.flash_attention_ref(*x, **kw).numpy()
    else:
        x = _t(_dot_inputs(9, 27, 64))
        one = dot_emulated(x, "1xtf32").numpy()
        plain = ref.dot_interact_ref(x).numpy()
    past = np.abs(one - plain) > F32_TOL["atol"] + F32_TOL["rtol"] * \
        np.abs(plain)
    assert past.sum() > 100


# The backward against its plain version on the card, relative to each
# gradient's largest magnitude (tests/test_torch_gpu.py, chip_smoke.py)
BWD_TOL = 5e-5


def _ta_bwd_inputs(b, n, t, d=36, h1=80, h2=40):
    """DIN's attention widths, padded histories (one user with none, one
    with all 100 steps), q and keys at the models' scale, dOut ~ N(0, 1)."""
    rng = np.random.default_rng(100 + n)
    f = np.float32
    q = (0.3 * rng.normal(size=(b, n, d))).astype(f)
    keys = (0.3 * rng.normal(size=(b, t, d))).astype(f)
    mask = (np.arange(t)[None] < rng.integers(1, t + 1, (b, 1))).astype(f)
    mask[0] = 0.0
    mask[1] = 1.0
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws.append((di ** -0.5 * rng.normal(size=(di, do))).astype(f))
        ws.append((0.1 * rng.normal(size=(do,))).astype(f))
    dout = rng.normal(size=(b, n, d)).astype(f)
    return dout, q, keys, mask, ws


def _ta_bwd_jax(dout, q, keys, mask, ws):
    """jax.grad of sum(dOut * pool) through the JAX package's
    ``din.attention_pool`` (each user's keys broadcast over its N
    candidates): (dq, dkeys, dW1, db1, dW2, db2, dW3, db3)."""
    import jax

    b, n, d = q.shape
    t = keys.shape[1]

    def loss(attn, qq, kk):
        kb = jnp.broadcast_to(kk[:, None], (b, n, t, d))
        mb = jnp.broadcast_to(jnp.asarray(mask)[:, None], (b, n, t))
        return jnp.sum(jdin.attention_pool({"attn": attn}, qq, kb, mb) * dout)

    attn = {"layers": [{"w": jnp.asarray(ws[2 * i]),
                        "b": jnp.asarray(ws[2 * i + 1])} for i in range(3)]}
    ga, gq, gk = jax.grad(loss, argnums=(0, 1, 2))(attn, jnp.asarray(q),
                                                   jnp.asarray(keys))
    lay = ga["layers"]
    return [np.asarray(x) for x in (gq, gk, lay[0]["w"], lay[0]["b"],
                                    lay[1]["w"], lay[1]["b"], lay[2]["w"],
                                    lay[2]["b"])]


def _ta_bwd_errors(mode, case):
    dout, q, keys, mask, ws = _ta_bwd_inputs(*case)
    got = ta_bwd_emulated(*map(_t, (dout, q, keys, mask, *ws)), mode)
    want = _ta_bwd_jax(dout, q, keys, mask, ws)
    errs = []
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        scale = float(np.abs(w).max()) or 1.0
        errs.append(float(np.abs(g - w).max()) / scale)
    return errs


TA_BWD_CASES = {"din-n1": (6, 1, 100), "n3": (3, 3, 20)}


@pytest.mark.parametrize("case", list(TA_BWD_CASES))
def test_target_attention_bwd_3xtf32_meets_the_gate(case):
    """The backward kernel's algebra with 3xTF32 products against jax.grad
    of the JAX attention pool at DIN's width (d = 36, h 80-40, T = 100, N
    = 1, padded histories) and at N = 3: every gradient within BWD_TOL of
    its largest magnitude (at most 7.3e-7 here).  One TF32 pass would not
    meet it: its errors reach 8.5e-4 at DIN's width and 2.6e-4 at N = 3,
    every gradient but db3 past the gate
    (``test_target_attention_bwd_one_tf32_pass_misses_the_gate``)."""
    errs = _ta_bwd_errors("3xtf32", TA_BWD_CASES[case])
    assert max(errs) <= BWD_TOL, errs
    assert max(_ta_bwd_errors("f32", TA_BWD_CASES[case])) <= BWD_TOL


@pytest.mark.parametrize("case", list(TA_BWD_CASES))
def test_target_attention_bwd_one_tf32_pass_misses_the_gate(case):
    errs = _ta_bwd_errors("1xtf32", TA_BWD_CASES[case])
    assert sum(e > BWD_TOL for e in errs) >= 5, errs
