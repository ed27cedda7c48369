"""glm4-9b [hf:THUDM/glm-4-9b], the JAX package's config on one card.

40L d_model=4096 32H (GQA kv=2, d_head=128) d_ff=13696 vocab=151552;
RoPE over half the head dim (partial rotary), SwiGLU, RMSNorm, an untied
head.  9,399,767,040 parameters: 37.6 GB in f32 as ``init`` draws them,
18.8 GB in bf16 as the cells serve them.  Its prefill runs the bf16
flash kernel at a GQA group of 16 (32 query heads on 2 kv heads).

The cells keep every width and all 40 layers and cut the batch to what
one 80 GB card holds (``CELL_BATCH``):
  * prefill_32k: B = 4, cut from 32.  At B = 32 the two (B, 32,768,
    13,696) bf16 SwiGLU intermediates alone are 57.4 GB beside the
    weights; at B = 4 they are 7.2 GB, with a 5.4 GB cache.
  * decode_32k: B = 32, cut from 128.  The bf16 KV cache is 1.34 GB for
    each sequence of 32,768 positions (2 L S Hkv dh values), so B = 32
    holds 42.9 GB of cache beside the weights (B = 128 would be 171.8
    GB).
  * train_4k: B = 8 sequences of 4,096, cut from 256, in
    ``base.LM_TRAIN_MICRO`` = 2 microbatches of 4 (the JAX cell: 8 of
    32), and the depth cut to ``TRAIN_LAYERS`` = 12 of 40, the most that
    fit.  The reckoning: f32 parameters, gradients and AdamW's two
    moments cost 16 bytes a parameter; the untied embedding and head
    take 1.24 B parameters (19.9 GB), a layer 204 M (3.27 GB), and with
    its bf16 weight copy and checkpointed input about 4.1 GB of the
    step's peak.  On an H100 (85.0 GB to allocate) 10 layers peaked at
    67.4 GB; 13 peaked at 79.6 GB allocated (83.5 GB reserved) in a
    process of their own, but ran out of memory after the smoke's earlier
    cells, with 6.7 GB reserved and unallocated (a layer's gradient
    arrives as a full-size (L, ...) buffer, 2.9 GB at 13 layers).  Each
    layer is checkpointed.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "glm4-9b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "long_500k": "pure full-attention stack (no sub-quadratic path); "
                 "skipped per brief - see DESIGN.md §5",
}
# cut from 32, 128 and 256
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 32, "train_4k": 8}
TRAIN_LAYERS = 12  # of 40: the most whose f32 training state fits
TRAIN_CUTS = {"batch": "256 -> 8", "microbatches": "8 of 32 -> 2 of 4",
              "n_layers": f"40 -> {TRAIN_LAYERS}"}


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID, n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_head=128, d_ff=13696, vocab=151552, padded_vocab=151552,
        rope_theta=10_000.0, rope_fraction=0.5, tie_embeddings=False,
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=128, padded_vocab=128,
        rope_fraction=0.5, tie_embeddings=False, dtype="float32",
        remat=False,
    )


def make_cell(shape: str, cfg: lm.LMConfig | None = None) -> base.Cell:
    """The cell of ``shape``; train_4k at the full widths runs
    ``TRAIN_LAYERS`` layers (``cfg``'s depth is cut, its widths kept)."""
    cfg = cfg or full_config()
    if shape == "train_4k" and not cfg.name.endswith("-smoke"):
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    return base.lm_cell(ARCH_ID, cfg, shape, skipped=SKIPPED_SHAPES,
                        cell_batch=CELL_BATCH, cuts=TRAIN_CUTS)


def init_smoke(gen, cfg, device=None):
    return lm.init(gen, cfg, device)


def smoke_batch(rng, cfg, device=None) -> dict:
    """The JAX package's ``lm_smoke_batch``: 2 sequences of 16 tokens."""
    return base.lm_batch(rng, cfg.vocab, 2, 16, device or "cpu")


def smoke_loss(params, cfg, batch):
    return lm.loss_fn(params, cfg, batch)
