"""Computation measure module (paper Fig. 2, step 2).

Closed-form per-layer counts: the allocator needs the chain costs c_j
without running anything, so they come from the model shapes alone.
"""
from __future__ import annotations

from typing import Sequence

# ---------------------------------------------------------------------------
# Analytic counts (multiply-add = 2 FLOPs)
# ---------------------------------------------------------------------------


def dense_flops(d_in: int, d_out: int, batch: int = 1,
                use_bias: bool = True) -> float:
    f = 2.0 * d_in * d_out
    if use_bias:
        f += d_out
    return f * batch


def mlp_flops(dims: Sequence[int], batch: int = 1) -> float:
    return sum(dense_flops(dims[i], dims[i + 1], batch)
               for i in range(len(dims) - 1))


def attention_flops(seq_q: int, seq_kv: int, n_heads: int, d_head: int,
                    batch: int = 1) -> float:
    """QK^T + softmax*V (projections counted separately via dense_flops)."""
    qk = 2.0 * seq_q * seq_kv * n_heads * d_head
    av = 2.0 * seq_q * seq_kv * n_heads * d_head
    softmax = 5.0 * seq_q * seq_kv * n_heads
    return (qk + av + softmax) * batch


def gru_flops(seq: int, d_in: int, d_hidden: int, batch: int = 1) -> float:
    """3 gates, each (d_in + d_hidden) -> d_hidden matmuls per step."""
    per_step = 3 * (dense_flops(d_in, d_hidden) + dense_flops(d_hidden, d_hidden))
    return (per_step + 9.0 * d_hidden) * seq * batch


def embedding_flops(n_lookups: int, dim: int) -> float:
    """Lookups are gathers: ~0 MACs; count the bag-sum adds."""
    return float(n_lookups * dim)


def transformer_layer_flops(seq: int, d_model: int, n_heads: int,
                            n_kv_heads: int, d_head: int, d_ff: int,
                            *, gated_ffn: bool = True, causal: bool = True,
                            batch: int = 1) -> float:
    q = dense_flops(d_model, n_heads * d_head, seq)
    kv = 2 * dense_flops(d_model, n_kv_heads * d_head, seq)
    o = dense_flops(n_heads * d_head, d_model, seq)
    attn = attention_flops(seq, seq, n_heads, d_head) * (0.5 if causal else 1.0)
    n_mats = 3 if gated_ffn else 2
    ffn = n_mats * dense_flops(d_model, d_ff, seq)
    return (q + kv + o + attn + ffn) * batch


def lm_train_step_flops(n_params: float, n_tokens: float) -> float:
    """The 6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params * n_tokens
