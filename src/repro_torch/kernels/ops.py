"""Public wrappers of the port's CUDA kernels.

A CUDA tensor goes to the hand-written kernel (``kernels/csrc``, built
on first use by ``kernels.build``); a CPU tensor goes to the kernel's
plain-torch version in ``kernels.ref``.  Any other device, tensors on
more than one device, or a kernel that fails to build or launch, raises
- nothing falls back.  The binding (``csrc/bind.cpp``) checks shapes,
types and layout and launches under the inputs' device guard, on that
device's current stream; it never synchronises.

Gradients.  ``target_attention`` and ``embedding_bag`` are
``torch.autograd.Function``s when autograd needs them (grad mode on and
an input that requires a gradient): the forward runs as above, and the
backward runs the hand-written backward kernel on the card
(``target_attention_bwd``, ``embedding_bag_bwd``) and its plain version
in ``kernels.ref`` on the CPU.  Only the inputs are saved; the backward
recomputes the rest.  Without autograd (serving, ``no_grad``, a CUDA
graph capture) they launch exactly what they did before.  An input
whose gradient no path needs (the attention mask, the bag's weights)
raises if it requires one; so does a CUDA input that requires a
gradient through a kernel that has no backward yet (``dot_interact``,
``cin_layer``, ``flash_attention``: ROADMAP queue A item 25) - nothing
returns a tensor without a ``grad_fn`` in its place.

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
            "target_attention_bwd": 0, "embedding_bag_bwd": 0}

NO_BACKWARD = ("has no backward kernel yet (ROADMAP queue A item 25: the "
               "backward kernels of dot_interact, cin_layer and both flash "
               "attention kernels, for DLRM's, xDeepFM's and gemma2-2b's "
               "training)")


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


def _no_backward(name: str, *ts) -> None:
    """Raise when autograd needs a gradient through kernel ``name``,
    which has no backward, for inputs that are not all on the CPU (the
    plain version there is differentiated by autograd)."""
    if _needs_grad(*ts) and any(t.device.type != "cpu" for t in ts):
        raise NotImplementedError(f"{name} {NO_BACKWARD}; its inputs on "
                                  f"{ts[0].device} require a gradient")


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


def dot_interact(feats):
    """(B, F, D) f32 or bf16 -> (B, F(F-1)/2) strictly-lower-triangle
    pairwise dots in the input's dtype; see ``ref.dot_interact_ref``."""
    _no_backward("dot_interact", feats)
    if _on_cpu(feats):
        return ref.dot_interact_ref(feats)
    out = load().dot_interact(feats)
    if out.numel():  # launched for B > 0 and F > 1
        _count("dot_interact")
    return out


def cin_layer(w, x_prev, x0):
    """w (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), f32 ->
    (B, H_out, D); see ``ref.cin_layer_ref``."""
    _no_backward("cin_layer", w, x_prev, x0)
    if _on_cpu(w, x_prev, x0):
        return ref.cin_layer_ref(w, x_prev, x0)
    out = load().cin_layer(w, x_prev, x0)
    # one count a call: the binding launches w's TF32 split, the product
    # and, when it cuts K into parts, their sum in a fixed order
    if out.numel() and w.shape[1]:  # launched unless empty or K = 0
        _count("cin_layer")
    return out


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
    dh = q.shape[-1]
    if dh % 8 or not 8 <= dh <= 256:
        raise ValueError(f"bf16 flash attention loads by TMA, which needs dh "
                         f"a multiple of 8 in [8, 256], got {dh}")
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    softcap: float | None = None,
                    scale: float | None = None):
    """q (B, T, H, dh), k/v (B, S, Hkv, dh), f32 or bf16 -> (B, T, H, dh)
    in q's dtype; GQA, causal (positions from 0), sliding window when
    ``window > 0``, tanh softcap when ``softcap`` is set, ``scale``
    defaulting to 1/sqrt(dh); see ``ref.flash_attention_ref``.  Ragged T
    and S need no padding.  On the card both dtypes run on the tensor
    cores: bf16 on the wgmma kernel, f32 on the 3xTF32 one
    (``flash_kernel``)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    _no_backward("flash_attention", q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    name = flash_kernel(q, k, v)
    out = getattr(load(), name)(q, k, v, bool(causal), int(window),
                                float(softcap or 0.0), float(scale))
    if out.numel():  # launched for B, T, H > 0
        _count(name)
    return out
