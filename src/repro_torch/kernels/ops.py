"""Public wrappers of the port's CUDA kernels.

A CUDA tensor goes to the hand-written kernel (``kernels/csrc``, built
on first use by ``kernels.build``); a CPU tensor goes to the kernel's
plain-torch version in ``kernels.ref``.  Any other device, tensors on
more than one device, or a kernel that fails to build or launch, raises
- nothing falls back.  The binding (``csrc/bind.cpp``) checks shapes,
types and layout and launches under the inputs' device guard, on that
device's current stream; it never synchronises.

Gradients.  Every kernel but the truncation is a
``torch.autograd.Function``: the forward runs as above, and the backward
runs the hand-written backward kernel on the card
(``target_attention_bwd``, ``embedding_bag_bwd``, ``dot_interact_bwd``,
``cin_layer_bwd``, ``flash_attention_bwd``) and its plain version in
``kernels.ref`` on the CPU.  The inputs are saved (and flash attention's
output); the backward recomputes the rest.  Without autograd (serving,
``no_grad``, a CUDA graph capture) each launches exactly what it
launches without a backward.  An input whose gradient no path needs
(the attention mask, the bag's weights) raises if it requires one.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one
right where it launches, and nowhere else, so a run can show that its
main path went through the kernels.  A CUDA graph capture runs the
wrappers' Python but launches nothing, and its replays launch without
running any Python: ``recording`` gathers a capture's counts apart, and
the graph's owner adds them with ``add_launches`` at every replay
(``repro_torch.graphs``), so the counts keep meaning launches that
happened.  Counting is thread-safe.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

LAUNCHES = {"cascade_truncate": 0, "target_attention": 0,
            "embedding_bag": 0, "dot_interact": 0, "cin_layer": 0,
            "flash_attention": 0, "flash_attention_wgmma": 0,
            "target_attention_bwd": 0, "embedding_bag_bwd": 0,
            "dot_interact_bwd": 0, "cin_layer_bwd": 0,
            "flash_attention_bwd": 0}


_LOCK = threading.Lock()
_CAPTURE = threading.local()  # .counts: the capture this thread records


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` (kernel -> launches) to ``LAUNCHES``."""
    with _LOCK:
        for k, v in counts.items():
            LAUNCHES[k] += v


@contextlib.contextmanager
def recording():
    """While this thread captures a CUDA graph: the wrappers' counts go
    to the yielded dict, not to ``LAUNCHES`` (the capture launches
    nothing; each replay launches them all)."""
    prev = getattr(_CAPTURE, "counts", None)
    _CAPTURE.counts = counts = {}
    try:
        yield counts
    finally:
        _CAPTURE.counts = prev


def _count(name: str) -> None:
    counts = getattr(_CAPTURE, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    else:
        add_launches({name: 1})


def _on_cpu(*ts) -> bool:
    devs = {t.device for t in ts if t is not None}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs must all lie on the CPU or all "
                         f"on one CUDA device, got {sorted(map(str, devs))}")
    return False


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def cascade_truncate(p_sorted, clicks_sorted, groups, rows, n3, *,
                     expose: int):
    """(B,) revenue@expose from (G, U, C) CompactPlan tables; see
    ``ref.cascade_truncate_ref``."""
    if _on_cpu(p_sorted, clicks_sorted, groups, rows, n3):
        return ref.cascade_truncate_ref(p_sorted, clicks_sorted, groups,
                                        rows, n3, expose=expose)
    out = load().cascade_truncate(p_sorted, clicks_sorted, groups, rows, n3,
                                  int(expose))
    if groups.shape[0]:  # the binding launches for B > 0
        _count("cascade_truncate")
    return out


def target_attention_bwd(dout, q, keys, mask, w1, b1, w2, b2, w3, b3):
    """The backward of ``target_attention``: dout (B, N, d) -> (dq, dkeys,
    dW1, db1, dW2, db2, dW3, db3), each shaped like its input; see
    ``ref.target_attention_bwd_ref``."""
    args = (dout, q, keys, mask, w1, b1, w2, b2, w3, b3)
    if _on_cpu(*args):
        return ref.target_attention_bwd_ref(*args)
    out = tuple(load().target_attention_bwd(*args))
    if q.shape[0] and q.shape[1]:  # launched for B, N > 0
        _count("target_attention_bwd")
    return out


class _TargetAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, keys, mask, w1, b1, w2, b2, w3, b3):
        args = (q, keys, mask, w1, b1, w2, b2, w3, b3)
        ctx.save_for_backward(*args)
        if _on_cpu(*args):
            return ref.target_attention_ref(*args)
        out = load().target_attention(*args)
        if q.shape[0] and q.shape[1]:  # launched for B, N > 0
            _count("target_attention")
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        grads = target_attention_bwd(dout, *ctx.saved_tensors)
        dq, dk, *dw = grads
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, None,
                *(g if n else None for g, n in zip(dw, need[3:])))


def target_attention(q, keys, mask, w1, b1, w2, b2, w3, b3):
    """(B, N, d) candidates against per-user (B, T, d) keys -> (B, N, d)
    pooled keys; see ``ref.target_attention_ref``.  ``q`` may share one
    candidate list across users (batch stride 0, e.g. ``expand``).
    Differentiable in q, keys and the MLP's weights; not in ``mask``."""
    if _needs_grad(mask):
        raise ValueError("target_attention has no gradient for the mask "
                         "(no path needs one); detach it")
    return _TargetAttention.apply(q, keys, mask, w1, b1, w2, b2, w3, b3)


def embedding_bag_bwd(dout, ids, weights, num_rows: int):
    """The backward of ``embedding_bag`` into its table: dout (B, D) ->
    the dense (num_rows, D) gradient; see ``ref.embedding_bag_bwd_ref``."""
    if _on_cpu(dout, ids, weights):
        return ref.embedding_bag_bwd_ref(dout, ids, weights, num_rows)
    out = load().embedding_bag_bwd(dout, ids, weights, int(num_rows))
    if out.numel() and ids.numel():  # launched for V, D, B * L > 0
        _count("embedding_bag_bwd")
    return out


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(ids, weights)
        ctx.num_rows = table.shape[0]
        if _on_cpu(table, ids, weights):
            return ref.embedding_bag_ref(table, ids, weights)
        out = load().embedding_bag(table, ids, weights)
        if out.numel():  # launched for B, D > 0
            _count("embedding_bag")
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        ids, weights = ctx.saved_tensors
        return embedding_bag_bwd(dout, ids, weights, ctx.num_rows), None, None


def embedding_bag(table, ids, weights=None):
    """(B, L) bags into a (V, D) table -> (B, D) (weighted) sums; see
    ``ref.embedding_bag_ref``.  Differentiable in the table; not in the
    weights."""
    if _needs_grad(weights):
        raise ValueError("embedding_bag has no gradient for the bag "
                         "weights (no path needs one); detach them")
    return _EmbeddingBag.apply(table, ids, weights)


def dot_interact_bwd(dout, feats):
    """The backward of ``dot_interact``: dout (B, F(F-1)/2) -> dfeats
    (B, F, D) in feats' dtype; see ``ref.dot_interact_bwd_ref``."""
    if _on_cpu(dout, feats):
        return ref.dot_interact_bwd_ref(dout, feats)
    out = load().dot_interact_bwd(dout, feats)
    if out.numel():  # launched for B, F, D > 0
        _count("dot_interact_bwd")
    return out


class _DotInteract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        if _on_cpu(feats):
            return ref.dot_interact_ref(feats)
        out = load().dot_interact(feats)
        if out.numel():  # launched for B > 0 and F > 1
            _count("dot_interact")
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        return dot_interact_bwd(dout, *ctx.saved_tensors)


def dot_interact(feats):
    """(B, F, D) f32 or bf16 -> (B, F(F-1)/2) strictly-lower-triangle
    pairwise dots in the input's dtype; see ``ref.dot_interact_ref``.
    Differentiable in feats."""
    return _DotInteract.apply(feats)


def cin_layer_bwd(dz, w, x_prev, x0):
    """The backward of ``cin_layer``: dz (B, H_out, D) -> (dw, dx_prev,
    dx0), each shaped like its input; see ``ref.cin_layer_bwd_ref``."""
    if _on_cpu(dz, w, x_prev, x0):
        return ref.cin_layer_bwd_ref(dz, w, x_prev, x0)
    out = tuple(load().cin_layer_bwd(dz, w, x_prev, x0))
    # one count a call: the binding launches the layout pre-passes (dz,
    # x0 and x_prev transposed, w^T split into TF32 halves), the input
    # gradients' kernel, dw's kernel and, when it cuts the batch into
    # parts, their sum in a fixed order
    if dz.numel() and w.shape[1]:  # launched unless empty or K = 0
        _count("cin_layer_bwd")
    return out


class _CinLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x_prev, x0):
        ctx.save_for_backward(w, x_prev, x0)
        if _on_cpu(w, x_prev, x0):
            return ref.cin_layer_ref(w, x_prev, x0)
        out = load().cin_layer(w, x_prev, x0)
        # one count a call: the binding launches w's TF32 split, the
        # product and, when it cuts K into parts, their sum in a fixed
        # order
        if out.numel() and w.shape[1]:  # launched unless empty or K = 0
            _count("cin_layer")
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        grads = cin_layer_bwd(dz, *ctx.saved_tensors)
        return tuple(g if n else None
                     for g, n in zip(grads, ctx.needs_input_grad))


def cin_layer(w, x_prev, x0):
    """w (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), f32 ->
    (B, H_out, D); see ``ref.cin_layer_ref``.  Differentiable in all
    three."""
    return _CinLayer.apply(w, x_prev, x0)


def _check_tma_head(dh: int, what: str) -> None:
    """Raises ValueError unless TMA can read rows of ``dh`` bf16 values:
    a multiple of 8 (16 bytes) in [8, 256]."""
    if dh % 8 or not 8 <= dh <= 256:
        raise ValueError(f"{what} loads by TMA, which needs dh a multiple of "
                         f"8 in [8, 256], got {dh}")


def flash_kernel(q, k, v) -> str:
    """The kernel a CUDA call of ``flash_attention`` launches, by dtype:
    ``"flash_attention_wgmma"`` (bf16 wgmma, TMA loads) for bf16,
    ``"flash_attention"`` (f32 products as 3xTF32 on mma.sync, cp.async
    loads, any dh in [1, 256] and any strides with dh contiguous)
    otherwise.  Reads only dtypes, shapes, strides and base addresses, so
    it runs on any device.

    TMA reads the tensors through their strides, so a bf16 call needs dh a
    multiple of 8 in [8, 256], base addresses aligned to 16 bytes and the
    other strides (of dimensions longer than 1) multiples of 16 bytes; one
    that breaks a rule raises ValueError naming it.  A tensor whose dh is
    not contiguous is copied first, and then meets the rules."""
    if q.dtype != torch.bfloat16:
        return "flash_attention"
    _check_tma_head(q.shape[-1], "bf16 flash attention")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            continue  # copied to a contiguous tensor
        if x.data_ptr() % 16:
            raise ValueError(f"bf16 flash attention loads by TMA, which needs "
                             f"base addresses aligned to 16 bytes; {name}'s "
                             f"is not")
        if any(x.shape[d] > 1 and (x.stride(d) * x.element_size()) % 16
               for d in range(x.dim() - 1)):
            raise ValueError(f"bf16 flash attention loads by TMA, which needs "
                             f"strides that are multiples of 16 bytes; {name} "
                             f"has strides {tuple(x.stride())} (elements)")
    return "flash_attention_wgmma"


def _empty_query_rows(t: int, s: int, window: int) -> bool:
    """Whether a query row admits no key: with a window, row t sees keys
    in (t - window, t] (causal) or (t - window, S) and none once t >= S +
    window - 1; without one, row t always sees key 0."""
    return window > 0 and t > s + window - 1


def flash_attention_bwd(dout, q, k, v, out, *, causal: bool = True,
                        window: int = -1, softcap: float | None = None,
                        scale: float | None = None):
    """The backward of ``flash_attention``: dout and the forward's output
    (B, T, H, dh) -> (dq, dk, dv) shaped and typed like q, k and v; see
    ``ref.flash_attention_bwd_ref``.  Raises ValueError when a query row
    admits no key (its forward weighs masked keys alike; no path needs
    its gradient) and, on the card, for a bf16 dh that TMA cannot read
    (as the bf16 forward does)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if _empty_query_rows(q.shape[1], k.shape[1], window):
        raise ValueError(f"flash attention's backward needs every query "
                         f"row to admit a key: T = {q.shape[1]} > S + "
                         f"window - 1 = {k.shape[1] + window - 1}")
    if _on_cpu(dout, q, k, v, out):
        return ref.flash_attention_bwd_ref(dout, q, k, v, out, causal=causal,
                                           window=window, softcap=softcap,
                                           scale=scale)
    if q.dtype == torch.bfloat16:
        _check_tma_head(q.shape[-1], "bf16 flash attention's backward")
    grads = tuple(load().flash_attention_bwd(
        dout, q, k, v, out, bool(causal), int(window), float(softcap or 0.0),
        float(scale)))
    # one count a call: the binding launches three kernels, the rows'
    # log-sum-exp and rowsum(dO o O), then dk and dv a kv tile a block,
    # then dq a query tile a block (bf16: wgmma with TMA loads; f32: the
    # CUDA cores)
    if q.numel() and k.shape[1]:  # launched for B, T, H, S > 0
        _count("flash_attention_bwd")
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        if _on_cpu(q, k, v):
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, softcap=softcap,
                                          scale=scale)
        else:
            name = flash_kernel(q, k, v)
            out = getattr(load(), name)(q, k, v, bool(causal), int(window),
                                        float(softcap or 0.0), float(scale))
            if out.numel():  # launched for B, T, H > 0
                _count(name)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        grads = flash_attention_bwd(dout, q, k, v, out, **ctx.opts)
        return (*(g if n else None
                  for g, n in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    softcap: float | None = None,
                    scale: float | None = None):
    """q (B, T, H, dh), k/v (B, S, Hkv, dh), f32 or bf16 -> (B, T, H, dh)
    in q's dtype; GQA, causal (positions from 0), sliding window when
    ``window > 0``, tanh softcap when ``softcap`` is set, ``scale``
    defaulting to 1/sqrt(dh); see ``ref.flash_attention_ref``.  Ragged T
    and S need no padding.  On the card both dtypes run on the tensor
    cores: bf16 on the wgmma kernel, f32 on the 3xTF32 one
    (``flash_kernel``).  Differentiable in q, k and v
    (``flash_attention_bwd``)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
