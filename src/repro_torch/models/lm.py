"""Decoder-only LM, the port of ``repro/models/lm.py`` for one card.

One implementation, config-selected features, as in the JAX package:
  * GQA (n_kv_heads <= n_heads), RoPE (partial fraction, theta) on
    interleaved pairs,
  * dense gated FFN (SwiGLU/GeGLU) or a top-k MoE FFN on one card
    (``_moe_grouped``: tokens grouped by expert, one product an expert,
    no token dropped; ``_moe_ref`` computes every expert, the JAX
    package's ``_moe_ref``),
  * gemma2: local/global alternating sliding window, attention and final
    logit softcap, zero-centered RMSNorm, sandwich (pre+post) norms,
  * QK-norm; minicpm's embedding scale, depth-scaled residuals and logit
    divisor,
  * parameters stacked on a leading (L,) dim, the same tree as
    ``lm.init``, so the bridge carries JAX weights over leaf by leaf.

The layers run in a Python loop, so each layer's sliding window is a
Python int and the self-attention of ``forward``, ``loss_fn`` and
``prefill`` goes through the hand-written flash-attention kernel
(``kernels.ops``), whose backward kernel carries ``loss_fn``'s gradient.
Training checkpoints each layer when ``remat`` is set (the JAX
package's ``jax.checkpoint`` of the layer scan): a layer's activations
are recomputed in the backward pass, flash attention's forward kernel
included.
``decode_step`` attends one query against the cache with the plain
``_attention``, as the JAX package does, reading only the positions its
mask admits.  The KV cache is allocated once and written in place.
There is no mesh: sharding specs, ``constrain`` and the expert-parallel
MoE (``_moe_ep``, with its capacity drop) of the JAX package have no
counterpart here.  Matrices may be stored in f32 (``init``) or already
in the compute dtype; each use casts to the activations' dtype, a no-op
for the latter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L

INT32_MAX = 2 ** 31 - 1
# positions a chunk of the loss's logits: their f32 copy is 2.1 GB at
# gemma2-2b's 256,000 vocabulary, and each chunk is recomputed in the
# backward pass instead of kept
LOSS_CHUNK = 2048
# host reads of the MoE's per-expert row counts (one a MoE layer call:
# the split sizes of ``_moe_grouped``); a caller may reset and read it
HOST_READS = {"moe_counts": 0}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    padded_vocab: int
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    moe: MoEConfig | None = None
    window_pattern: tuple | None = None  # e.g. (4096, -1): local, global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    sandwich_norm: bool = False
    zero_centered_norm: bool = False
    gated_ffn: bool = True
    act: str = "silu"  # silu | gelu (tanh form)
    embed_scale: float | None = None
    residual_scale: float = 1.0
    logit_divisor: float = 1.0
    tie_embeddings: bool = True
    query_scale: float | None = None  # default 1/sqrt(d_head)
    dtype: str = "bfloat16"  # activation/compute dtype
    remat: bool = True  # checkpoint each layer in training

    def __post_init__(self):
        # the JAX masks read 0 as "no key" in prefill, "global" in decode
        if self.window_pattern and 0 in self.window_pattern:
            raise ValueError("a sliding window of 0 is not supported")

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    def window_for_layer(self, i: int) -> int:
        if not self.window_pattern:
            return -1
        return self.window_pattern[i % len(self.window_pattern)]

    def n_params(self) -> float:
        """Total parameter count (embedding included once if tied)."""
        d, n = self.d_model, self.n_layers
        attn = d * (self.d_q + 2 * self.d_kv) + self.d_q * d
        n_mats = 3 if self.gated_ffn else 2
        if self.moe:
            ffn = self.moe.n_experts * n_mats * d * self.moe.d_expert
            ffn += d * self.moe.n_experts  # router
        else:
            ffn = n_mats * d * self.d_ff
        norms = 4 * d if self.sandwich_norm else 2 * d
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return n * (attn + ffn + norms) + emb + d

    def n_active_params(self) -> float:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d, n = self.d_model, self.n_layers
        attn = d * (self.d_q + 2 * self.d_kv) + self.d_q * d
        n_mats = 3 if self.gated_ffn else 2
        ffn = self.moe.top_k * n_mats * d * self.moe.d_expert
        ffn += d * self.moe.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return n * (attn + ffn) + emb + d


# -- RoPE -------------------------------------------------------------------


def rope_freqs(cfg: LMConfig, device=None) -> torch.Tensor:
    rot = int(cfg.d_head * cfg.rope_fraction)
    rot -= rot % 2
    ex = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** ex)  # (rot/2,)


def apply_rope(x, positions, cfg: LMConfig):
    """x (B, T, H, dh), positions (B, T) -> x rotated on interleaved
    pairs (x[0::2], x[1::2]) of its first ``rot`` dims, in f32, cast
    back to x's dtype."""
    inv = rope_freqs(cfg, x.device)
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv  # (B, T, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot].float(), x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    yr = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([yr.reshape(xr.shape).to(x.dtype), xp], dim=-1)


# -- init -------------------------------------------------------------------


def _normal(gen, shape, std):
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return out.mul_(std)


def init(gen: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """Stacked-layer params in f32, every layer tensor with a leading (L,)
    dim: the tree of the JAX package's ``lm.init``.  The matrices are
    drawn on ``device`` from a generator there, seeded from ``gen`` (2.6 B
    normals for gemma2-2b would take 10.5 GB of host memory), so the
    same seed gives other weights on the CPU than on the card."""
    device = torch.device(device or "cpu")
    g = L.device_generator(gen, device)
    d, n = cfg.d_model, cfg.n_layers
    wo_std = 0.02 / math.sqrt(2 * n)

    def norm():
        return {"scale": torch.ones((n, d), device=device)}

    lay = {
        "wq": _normal(g, (n, d, cfg.d_q), 0.02),
        "wk": _normal(g, (n, d, cfg.d_kv), 0.02),
        "wv": _normal(g, (n, d, cfg.d_kv), 0.02),
        "wo": _normal(g, (n, cfg.d_q, d), wo_std),
        "ln_attn": norm(),
        "ln_ffn": norm(),
    }
    if cfg.sandwich_norm:
        lay["ln_attn_post"] = norm()
        lay["ln_ffn_post"] = norm()
    if cfg.qk_norm:
        lay["q_norm"] = {"scale": torch.ones((n, cfg.d_head), device=device)}
        lay["k_norm"] = {"scale": torch.ones((n, cfg.d_head), device=device)}
    if cfg.moe:
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        lay["router"] = _normal(g, (n, d, e), 0.02)
        lay["w1"] = _normal(g, (n, e, d, f), 0.02)
        lay["w2"] = _normal(g, (n, e, f, d), wo_std)
        if cfg.gated_ffn:
            lay["w3"] = _normal(g, (n, e, d, f), 0.02)
    else:
        lay["w1"] = _normal(g, (n, d, cfg.d_ff), 0.02)
        lay["w2"] = _normal(g, (n, cfg.d_ff, d), wo_std)
        if cfg.gated_ffn:
            lay["w3"] = _normal(g, (n, d, cfg.d_ff), 0.02)
    params = {
        "embed": _normal(g, (cfg.padded_vocab, d), 0.02),
        "layers": lay,
        "ln_final": L.rmsnorm_init(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(g, (cfg.padded_vocab, d), 0.02)
    return params


def cast_params(params: dict, dtype) -> dict:
    """The tree with every matrix cast to ``dtype`` once (norm scales stay
    f32).  Gives the numbers of the JAX package's cast at each use."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype)
        else:
            out[k] = v if k == "scale" else v.to(dtype)
    return out


def _layer(params: dict, i: int) -> dict:
    """Layer i's leaves (views of the stacked tensors)."""
    return {k: ({"scale": v["scale"][i]} if isinstance(v, dict) else v[i])
            for k, v in params["layers"].items()}


# -- attention --------------------------------------------------------------


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _attn_mask(q_pos, k_pos, window: int):
    """Causal + optional sliding window.  window < 0 => global."""
    causal = k_pos[None, :] <= q_pos[:, None]
    w = INT32_MAX if window < 0 else window
    return causal & ((q_pos[:, None] - k_pos[None, :]) < w)


def _scale(cfg: LMConfig) -> float:
    return cfg.query_scale or 1.0 / math.sqrt(cfg.d_head)


def _attention(cfg: LMConfig, q, k, v, mask):
    """Plain attention: q (B,T,H,dh), k/v (B,S,Hkv,dh), mask (T,S) or
    (B,T,S) -> (B, T, d_q).  Logits come out of a product in the compute
    dtype, then f32, as in the JAX package.  One kv head at a time:
    ``k[:, :, j]`` is a strided (S, dh) matrix per sequence that ``bmm``
    reads in place, where an einsum over the (B, S, Hkv, dh) layout
    would copy the whole cache first."""
    groups = cfg.n_heads // cfg.n_kv_heads
    b, t = q.shape[0], q.shape[1]
    if mask.dim() == 2:
        mask = mask[None]
    mask = mask[:, None]  # (B or 1, 1, T, S)
    neg = torch.tensor(-1e30, device=q.device)
    outs = []
    for j in range(cfg.n_kv_heads):
        qj = q[:, :, j * groups:(j + 1) * groups].transpose(1, 2)
        qj = qj.reshape(b, groups * t, cfg.d_head)
        logits = torch.bmm(qj, k[:, :, j].transpose(1, 2)).float()
        logits = logits.view(b, groups, t, -1) * _scale(cfg)
        if cfg.attn_softcap:
            logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
        logits = torch.where(mask, logits, neg)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.bmm(probs.view(b, groups * t, -1), v[:, :, j])
        outs.append(out.view(b, groups, t, cfg.d_head))
    out = torch.stack(outs, dim=1)  # (B, Hkv, G, T, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, cfg.d_q)


def _qkv(p, cfg: LMConfig, x, positions):
    """Projected, normed and rotated q (B,T,H,dh), k and v (B,T,Hkv,dh)."""
    q = _split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, cfg.d_head)
    k = _split_heads(x @ p["wk"].to(x.dtype), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(x @ p["wv"].to(x.dtype), cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        zc = cfg.zero_centered_norm
        q = L.rmsnorm_apply(p["q_norm"], q, zero_centered=zc)
        k = L.rmsnorm_apply(p["k_norm"], k, zero_centered=zc)
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg), v


def _attn_block(p, cfg: LMConfig, x, positions, window: int, kv=None,
                pos: int = 0):
    """Attention of x (B,T,d) -> (out (B,T,d), (k, v)).  Without ``kv``,
    causal self-attention at positions 0..T-1 through the flash-attention
    kernel.  With ``kv``, this layer's (k_cache, v_cache), a decode step
    at position ``pos``: its k and v are written there in place and the
    plain ``_attention`` reads only the cached positions the mask admits
    (the JAX package masks the rest, which take weights of exactly 0)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if kv is None:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap,
                                  scale=_scale(cfg))
        out = out.reshape(*x.shape[:2], cfg.d_q)
    else:
        k_cache, v_cache = kv
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        lo = max(0, pos - window + 1) if window > 0 else 0
        kv_pos = torch.arange(lo, pos + 1, device=x.device)
        out = _attention(cfg, q, k_cache[:, lo:pos + 1],
                         v_cache[:, lo:pos + 1],
                         _attn_mask(positions[0], kv_pos, window))
    return out @ p["wo"].to(x.dtype), (k, v)


# -- FFN --------------------------------------------------------------------


def _act(cfg: LMConfig):
    if cfg.act == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


def _dense_ffn(p, cfg: LMConfig, x):
    h = _act(cfg)(x @ p["w1"].to(x.dtype))
    if cfg.gated_ffn:
        h = h * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)


def _route(p, cfg: LMConfig, xt):
    """The JAX package's router: xt (n, d) -> (probs (n, E) f32, top_w
    (n, k) f32, top_e (n, k)).  The logits come out of a product in
    xt's dtype, then f32; softmax, the k largest probabilities in
    descending order, renormalized over the k.  Both MoE versions route
    through it, so they pick the same experts."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def _router_aux(probs, top_e, moe: MoEConfig):
    """Switch-style load-balance loss in f32: E * sum_e f_e * P_e, with
    f_e the share of tokens whose first choice is e and P_e the mean
    probability of e."""
    e = probs.shape[-1]
    hot = F.one_hot(top_e[..., 0], e).to(probs.dtype)
    return e * torch.sum(hot.mean(0) * probs.mean(0))


def _moe_ref(p, cfg: LMConfig, x):
    """The plain MoE, the JAX package's ``_moe_ref``: every expert
    computed for every token, then the gated combine in x's dtype.
    x (B, T, d) -> (out (B, T, d), aux)."""
    n = x.shape[0] * x.shape[1]
    xt = x.reshape(n, cfg.d_model)
    probs, top_w, top_e = _route(p, cfg, xt)
    gates = torch.zeros_like(probs).scatter(1, top_e, top_w)
    h = _act(cfg)(torch.einsum("nd,edf->nef", xt, p["w1"].to(x.dtype)))
    if cfg.gated_ffn:
        h = h * torch.einsum("nd,edf->nef", xt, p["w3"].to(x.dtype))
    y = torch.einsum("nef,efd->ned", h, p["w2"].to(x.dtype))
    out = torch.einsum("ned,ne->nd", y, gates.to(x.dtype))
    return out.reshape(x.shape), _router_aux(probs, top_e, cfg.moe)


class _Permute(torch.autograd.Function):
    """Rows ``x[order // k]``: with k = 1 the rows of x in ``order``;
    with k > 1 each of x's rows in each of its k slots, the n * k slots
    in ``order``.  The gradient goes back by the inverse permutation, a
    gather, and each row sums its k slots in slot order (``x[order]``'s
    own backward accumulates by atomics)."""

    @staticmethod
    def forward(ctx, x, order, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return x.index_select(0, order // k if k > 1 else order)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        g = grad.index_select(0, inverse)
        if ctx.k > 1:
            g = g.view(-1, ctx.k, g.shape[-1]).sum(1)
        return g, None, None, None


def _dispatch(top_e, n_experts: int):
    """top_e (n, k) -> (order, inverse, counts): the n * k assignments,
    flattened token-major, ordered by a stable sort on the expert id (so
    each expert's rows stay in token order), the inverse permutation and
    the number of rows of each expert (E,)."""
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return order, inverse, torch.bincount(flat, minlength=n_experts)


def _moe_grouped(p, cfg: LMConfig, x):
    """The MoE every cell runs: x (B, T, d) -> (out (B, T, d), aux).
    Each token's k rows, gathered in expert order (``_dispatch``,
    ``_Permute``), go through one ``act(x_e @ w1_e) * (x_e @ w3_e) @
    w2_e`` an expert that has rows, the experts' matrices from one ``unbind(0)`` of each leaf (so
    a leaf's gradient is stacked once).  The rows go back by the inverse
    permutation and each token sums its k rows in slot order, the gates
    in f32, then casts.  No token is dropped.  The per-expert row counts
    are the split sizes: one host read a call (``HOST_READS``).  No
    sum runs by atomics, so outputs and gradients repeat bitwise."""
    m = cfg.moe
    n, d, k = x.shape[0] * x.shape[1], cfg.d_model, m.top_k
    xt = x.reshape(n, d)
    probs, top_w, top_e = _route(p, cfg, xt)
    order, inverse, counts = _dispatch(top_e, m.n_experts)
    HOST_READS["moe_counts"] += 1
    counts = counts.tolist()
    rows = _Permute.apply(xt, order, inverse, k)
    w1 = p["w1"].to(x.dtype).unbind(0)
    w2 = p["w2"].to(x.dtype).unbind(0)
    w3 = p["w3"].to(x.dtype).unbind(0) if cfg.gated_ffn else None
    act, ys = _act(cfg), []
    for e, xe in enumerate(rows.split(counts)):
        if counts[e]:
            h = act(xe @ w1[e])
            if cfg.gated_ffn:
                h = h * (xe @ w3[e])
            ys.append(h @ w2[e])
    y = _Permute.apply(torch.cat(ys), inverse, order, 1).view(n, k, d)
    slots = y.unbind(1)
    out = slots[0].float() * top_w[:, :1]
    for j in range(1, k):
        out = out + slots[j].float() * top_w[:, j:j + 1]
    return (out.to(x.dtype).reshape(x.shape),
            _router_aux(probs, top_e, m))


def _ffn_block(p, cfg: LMConfig, x):
    """(out, aux): the dense FFN with aux 0.0, or the grouped MoE."""
    if cfg.moe is None:
        return _dense_ffn(p, cfg, x), 0.0
    return _moe_grouped(p, cfg, x)


# -- block + forward --------------------------------------------------------


def _block(p, cfg: LMConfig, x, positions, window: int, kv=None,
           pos: int = 0):
    zc = cfg.zero_centered_norm
    h = L.rmsnorm_apply(p["ln_attn"], x, zero_centered=zc)
    attn_out, new_kv = _attn_block(p, cfg, h, positions, window, kv, pos)
    if cfg.sandwich_norm:
        attn_out = L.rmsnorm_apply(p["ln_attn_post"], attn_out,
                                   zero_centered=zc)
    x = x + cfg.residual_scale * attn_out
    h = L.rmsnorm_apply(p["ln_ffn"], x, zero_centered=zc)
    ffn_out, aux = _ffn_block(p, cfg, h)
    if cfg.sandwich_norm:
        ffn_out = L.rmsnorm_apply(p["ln_ffn_post"], ffn_out, zero_centered=zc)
    return x + cfg.residual_scale * ffn_out, new_kv, aux


def _embed(params, cfg: LMConfig, tokens):
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    return x


def _unembed(params, cfg: LMConfig, x):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = x @ table.T.to(x.dtype)
    logits = logits / torch.tensor(cfg.logit_divisor, dtype=x.dtype)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _positions(b: int, t: int, device):
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _final_norm(params, cfg: LMConfig, x):
    return L.rmsnorm_apply(params["ln_final"], x,
                           zero_centered=cfg.zero_centered_norm)


def _hidden(params, cfg: LMConfig, tokens):
    """tokens (B, T) -> (the final-normed hidden states (B, T, d), the
    MoE's router aux summed over layers; 0.0 for a dense FFN).  With
    grad mode on and ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept,
    and its activations (the MoE's routing too) are recomputed in the
    backward pass."""
    b, t = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(b, t, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(cfg.n_layers):
        def layer(x, i=i):
            y, _, a = _block(_layer(params, i), cfg, x, positions,
                             cfg.window_for_layer(i))
            return y, a

        x, a = (checkpoint(layer, x, use_reentrant=False) if remat
                else layer(x))
        aux = aux + a
    return _final_norm(params, cfg, x), aux


@torch.no_grad()
def forward(params, cfg: LMConfig, tokens):
    """tokens (B, T) -> logits (B, T, padded_vocab); no loss (the MoE's
    aux is dropped)."""
    return _unembed(params, cfg, _hidden(params, cfg, tokens)[0])


def _token_nll(params, cfg: LMConfig, x, targets):
    """x (N, d) final-normed states, targets (N,) -> (N,) f32 NLL from
    f32 logits: logsumexp minus the target's logit."""
    logits = _unembed(params, cfg, x).float()
    picked = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def loss_fn(params, cfg: LMConfig, batch: dict):
    """The JAX package's masked next-token loss: batch tokens, targets
    (B, T) int and mask (B, T) -> sum(NLL * mask) / max(sum(mask), 1),
    the NLL from f32 logits, plus ``router_aux_weight`` x the layers'
    mean router aux for a MoE (the JAX package's term).  Differentiable
    (the flash kernel's backward carries attention's gradient).  The
    logits are formed ``LOSS_CHUNK`` positions at a time, each chunk
    under ``torch.utils.checkpoint`` when grad mode is on, so no more
    than a chunk's (LOSS_CHUNK, V) f32 logits live at once; the
    per-position NLL is the same function."""
    tokens = batch["tokens"]
    x, aux = _hidden(params, cfg, tokens)
    x = x.reshape(-1, x.shape[-1])
    targets = batch["targets"].reshape(-1)
    grad = torch.is_grad_enabled()

    def chunk(xs, ts):
        return _token_nll(params, cfg, xs, ts)

    nll = []
    for lo in range(0, x.shape[0], LOSS_CHUNK):
        xs, ts = x[lo:lo + LOSS_CHUNK], targets[lo:lo + LOSS_CHUNK]
        nll.append(checkpoint(chunk, xs, ts, use_reentrant=False)
                   if grad and x.shape[0] > LOSS_CHUNK else chunk(xs, ts))
    mask = batch["mask"].float()
    nll = torch.cat(nll).reshape(mask.shape) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


# -- serving: prefill + single-token decode with a KV cache -----------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Stacked (L, B, S, Hkv, dh) cache, zero, and its length (a Python
    int); sliding windows are applied through the mask against absolute
    positions, as in the JAX package."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens, max_len: int):
    """tokens (B, T) -> (last-token logits (B, V), cache).  Each layer's
    k and v are written into the cache in place."""
    b, t = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(b, t, tokens.device)
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    for i in range(cfg.n_layers):
        x, (k, v), _ = _block(_layer(params, i), cfg, x, positions,
                              cfg.window_for_layer(i))
        cache["k"][i, :, :t] = k
        cache["v"][i, :, :t] = v
    cache["length"] = t
    x = _final_norm(params, cfg, x[:, -1:, :])
    return _unembed(params, cfg, x)[:, 0], cache


@torch.no_grad()
def decode_step(params, cfg: LMConfig, token, cache: dict):
    """One serve step: token (B,) + cache -> (logits (B, V), cache).

    The new token's k and v are written into the cache at ``length``, in
    place (the returned cache shares the input's tensors)."""
    b = token.shape[0]
    pos = int(cache["length"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"cache of {cache['k'].shape[2]} positions is full")
    x = _embed(params, cfg, token[:, None])
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    for i in range(cfg.n_layers):
        x, _, _ = _block(_layer(params, i), cfg, x, positions,
                         cfg.window_for_layer(i),
                         kv=(cache["k"][i], cache["v"][i]), pos=pos)
    logits = _unembed(params, cfg, _final_norm(params, cfg, x))[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "length": pos + 1}


# -- FLOPs ------------------------------------------------------------------


def flops_per_token(cfg: LMConfig, seq_len: int, *,
                    decode: bool = False) -> float:
    """Forward FLOPs per token (attention quadratic term included)."""
    d = cfg.d_model
    proj = 2.0 * d * (cfg.d_q + 2 * cfg.d_kv) + 2.0 * cfg.d_q * d
    attn = 4.0 * cfg.n_heads * cfg.d_head * (seq_len if decode
                                             else seq_len / 2)
    n_mats = 3 if cfg.gated_ffn else 2
    if cfg.moe:
        ffn = n_mats * 2.0 * d * cfg.moe.d_expert * cfg.moe.top_k
        ffn += 2.0 * d * cfg.moe.n_experts
    else:
        ffn = n_mats * 2.0 * d * cfg.d_ff
    unembed = 2.0 * d * cfg.padded_vocab
    return cfg.n_layers * (proj + attn + ffn) + unembed
