"""xDeepFM (Lian et al. [arXiv:1803.05170]).

Assigned config: n_sparse=39, embed_dim=10, cin_layers=200-200-200,
mlp=400-400, interaction=CIN (Compressed Interaction Network).

CIN layer k:  X^k[b,h,d] = sum_{i,j} W^k[h,i,j] * X^{k-1}[b,i,d] * X^0[b,j,d]
(vector-wise outer product compressed by a 1x1 "conv"), through the
``cin_layer`` kernel, which never forms the outer product in device
memory.  Sum-pool over d of every layer's feature maps -> CIN logit.
Three heads (linear + CIN + DNN) sum into the final logit.

The 39 vocabularies stack into one table of 79,984,968 rows (1.6 GB in
bf16, plus a 0.16 GB linear table), which fits one card whole: the
lookups are plain gathers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flops import mlp_flops
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.embedding import stacked_offsets

# 39 sparse fields, Criteo-like tails plus extra fields (79,984,968 rows)
XDEEPFM_VOCABS = (
    10_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    5_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    10_000_000, 9_000_000, 40_000_000, 452_104, 12_606, 104, 35,
    1_000_000, 500_000, 250_000, 100_000, 50_000, 20_000, 10_000,
    5_000, 2_000, 1_000, 500, 200, 100,
)


@dataclass(frozen=True)
class XDeepFMConfig:
    vocab_sizes: tuple = XDEEPFM_VOCABS
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_hidden: tuple = (400, 400)
    table_dtype: str = "bfloat16"  # storage dtype
    lookup_dtype: str = "bfloat16"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


def init(gen: torch.Generator, cfg: XDeepFMConfig, *, pad_vocab_to: int = 1,
         device=None) -> dict:
    """The two tables are drawn on ``device`` in row chunks (from a
    generator on that device, seeded from ``gen``); the CIN and DNN
    weights on the CPU from ``gen``, then moved."""
    device = torch.device(device or "cpu")
    total = sum(cfg.vocab_sizes)
    rows = total + (-total) % pad_vocab_to
    m = cfg.n_sparse
    dt = getattr(torch, cfg.table_dtype)
    tgen = L.device_generator(gen, device)
    table = L.normal_table(tgen, rows, cfg.embed_dim, std=0.01, dtype=dt)
    linear = L.normal_table(tgen, rows, 1, std=0.01, dtype=dt)
    cin_w, h_prev = [], m
    for h in cfg.cin_layers:
        cin_w.append(L.glorot_uniform(gen, (h, h_prev * m)))
        h_prev = h
    return L.to_device({
        "tables": {"stacked": table},
        "linear": linear,
        "cin": cin_w,
        "cin_out": L.dense_init(gen, sum(cfg.cin_layers), 1),
        "dnn": L.mlp_init(gen, [m * cfg.embed_dim, *cfg.mlp_hidden, 1]),
    }, device)


def table_offsets(cfg: XDeepFMConfig, device=None) -> torch.Tensor:
    return stacked_offsets(cfg.vocab_sizes, device)


def cin_layer(w, x_prev, x0):
    """w (H_out, H_prev*m), x_prev (B, H_prev, D), x0 (B, m, D) ->
    (B, H_out, D), through the ``cin_layer`` kernel."""
    return ops.cin_layer(w, x_prev, x0)


def forward(params, cfg: XDeepFMConfig, batch: dict):
    """batch: sparse (B, 39) int -> (B,) logits."""
    table = params["tables"]["stacked"]
    flat = batch["sparse"].long() + table_offsets(cfg, table.device)[None]
    dt = getattr(torch, cfg.lookup_dtype)
    x0 = table[flat].to(dt)  # (B, m, D)
    lin = params["linear"][flat][..., 0].to(dt)
    y_lin = lin.float().sum(dim=-1)

    # CIN head (f32 math on the fetched embeddings); only the current
    # layer and the pooled sums stay alive
    x0 = x0.float()
    x = x0
    pooled = []
    for w in params["cin"]:
        x = cin_layer(w, x, x0)
        pooled.append(x.sum(dim=-1))  # (B, H_k)
    del x
    y_cin = L.dense_apply(params["cin_out"], torch.cat(pooled, dim=-1))[..., 0]

    # DNN head
    y_dnn = L.mlp_apply(params["dnn"], x0.reshape(x0.shape[0], -1),
                        act="relu")[..., 0]
    return y_lin + y_cin + y_dnn


def loss_fn(params, cfg: XDeepFMConfig, batch: dict):
    """Mean BCE of ``forward``'s logits against ``batch["label"]``; its
    gradient runs the ``cin_layer`` kernel's backward, a launch a
    layer."""
    return L.sigmoid_bce(forward(params, cfg, batch), batch["label"])


def retrieval_forward(params, cfg: XDeepFMConfig, user_batch: dict,
                      cand_sparse):
    """One request (sparse (1, 39)) against N candidates' item-side
    fields cand_sparse (N, n_item_fields), swapped into the last
    fields."""
    n, k = cand_sparse.shape
    sparse = user_batch["sparse"].expand(n, cfg.n_sparse).clone()
    sparse[:, -k:] = cand_sparse
    return forward(params, cfg, {"sparse": sparse})


def flops_per_example(cfg: XDeepFMConfig) -> float:
    m, d = cfg.n_sparse, cfg.embed_dim
    h_prev, cin = m, 0.0
    for h in cfg.cin_layers:
        cin += 2.0 * h * h_prev * m * d + h_prev * m * d  # contraction + outer
        h_prev = h
    dnn = mlp_flops([m * d, *cfg.mlp_hidden, 1])
    return cin + dnn + 2.0 * sum(cfg.cin_layers) + m
