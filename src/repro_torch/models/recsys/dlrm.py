"""DLRM-RM2 (Naumov et al. [arXiv:1906.00091]; RM2 sizing from the
DeepRecSys/accelerator literature).

Assigned config: n_dense=13, n_sparse=26, embed_dim=64,
bot_mlp=13-512-256-64, top_mlp=512-512-256-1, interaction=dot.

The `512` leading the top MLP is its input width: pairwise dots among the
27 feature vectors (26 sparse + bottom output) give 27*26/2 = 351 terms,
concat the 64-dim bottom output = 415, zero-padded to 512.  The 26
vocabularies stack into one table of 78,046,168 rows (10.0 GB in bf16),
which fits one card whole: the lookup is a plain gather.  The sharded
lookups of the JAX package wait for the multi-process port.  The
interaction runs in the ``dot_interact`` kernel, and its gradient in
that kernel's backward; the table's gradient is torch's own index
backward (the JAX gather lies outside any Pallas kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.flops import mlp_flops
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.embedding import stacked_offsets

# Criteo-like vocabulary sizes for the 26 sparse fields (78,046,168 rows).
CRITEO_VOCABS = (
    10_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    5_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    10_000_000, 9_000_000, 40_000_000, 452_104, 12_606, 104, 35,
)


@dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    vocab_sizes: tuple = CRITEO_VOCABS
    embed_dim: int = 64
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 256, 1)
    top_pad: int = 512  # interaction output padded to this width
    lookup_dtype: str = "bfloat16"  # dtype of the looked-up rows
    table_dtype: str = "bfloat16"  # storage dtype (halves the table)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def d_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2 + self.bot_mlp[-1]


def init(gen: torch.Generator, cfg: DLRMConfig, *, pad_vocab_to: int = 1,
         device=None) -> dict:
    """The stacked table is drawn on ``device`` in row chunks (from a
    generator on that device, seeded from ``gen``); the MLPs on the CPU
    from ``gen``, then moved."""
    device = torch.device(device or "cpu")
    total_rows = sum(cfg.vocab_sizes)
    pad = (-total_rows) % pad_vocab_to
    table = L.normal_table(L.device_generator(gen, device), total_rows + pad,
                           cfg.embed_dim, std=0.01,
                           dtype=getattr(torch, cfg.table_dtype))
    return L.to_device({
        "tables": {"stacked": table},
        "bot": L.mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp]),
        "top": L.mlp_init(gen, [cfg.top_pad, *cfg.top_mlp]),
    }, device)


def table_offsets(cfg: DLRMConfig, device=None) -> torch.Tensor:
    """Row offset of each field's sub-table inside the stacked table."""
    return stacked_offsets(cfg.vocab_sizes, device)


def lookup(params, cfg: DLRMConfig, sparse_ids):
    """sparse_ids (B, 26) per-field ids -> (B, 26, D) in the lookup
    dtype."""
    table = params["tables"]["stacked"]
    flat = sparse_ids.long() + table_offsets(cfg, table.device)[None, :]
    return table[flat].to(getattr(torch, cfg.lookup_dtype))


def dot_interact(feats):
    """feats (B, F, D) -> strictly-lower-triangle pairwise dots
    (B, F(F-1)/2), through the ``dot_interact`` kernel."""
    return ops.dot_interact(feats)


def forward(params, cfg: DLRMConfig, batch: dict):
    """batch: dense (B, 13) float, sparse (B, 26) int -> (B,) logits."""
    x = L.mlp_apply(params["bot"], batch["dense"], act="relu",
                    final_act="relu")  # (B, 64)
    emb = lookup(params, cfg, batch["sparse"])  # (B, 26, D)
    feats = torch.cat([x[:, None, :].to(emb.dtype), emb], dim=1)
    inter = dot_interact(feats).to(x.dtype)  # (B, 351) back to f32
    z = torch.cat([inter, x], dim=-1)  # (B, 415)
    pad = cfg.top_pad - z.shape[-1]
    if pad < 0:
        raise ValueError("top_pad smaller than interaction width")
    z = F.pad(z, (0, pad))
    return L.mlp_apply(params["top"], z, act="relu")[..., 0]


def loss_fn(params, cfg: DLRMConfig, batch: dict):
    """Mean BCE of ``forward``'s logits against ``batch["label"]``."""
    return L.sigmoid_bce(forward(params, cfg, batch), batch["label"])


def retrieval_forward(params, cfg: DLRMConfig, user_batch: dict,
                      cand_sparse):
    """One request (dense (1, 13), sparse (1, 26)) scored against N
    candidates' item-side fields cand_sparse (N, n_item_fields): the
    last n_item_fields sparse fields are swapped per candidate."""
    n, k = cand_sparse.shape
    dense = user_batch["dense"].expand(n, cfg.n_dense)
    sparse = user_batch["sparse"].expand(n, cfg.n_sparse).clone()
    sparse[:, -k:] = cand_sparse
    return forward(params, cfg, {"dense": dense, "sparse": sparse})


def flops_per_example(cfg: DLRMConfig) -> float:
    bot = mlp_flops([cfg.n_dense, *cfg.bot_mlp])
    f = cfg.n_sparse + 1
    inter = 2.0 * f * f * cfg.embed_dim
    top = mlp_flops([cfg.top_pad, *cfg.top_mlp])
    return bot + inter + top
