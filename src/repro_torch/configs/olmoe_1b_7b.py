"""olmoe-1b-7b [arXiv:2409.02060], the JAX package's config on one card.

16L d_model=2048 16H (kv=16, MHA, d_head=128) vocab=50304 (padded to
50,432), QK-norm; a MoE FFN of 64 experts, top 8, d_expert=1024
(SwiGLU); an untied head.  6,919,620,608 parameters, 1,282,410,496
active a token: 27.7 GB in f32 as ``init`` draws them, 13.8 GB in bf16
as the cells serve them.  Its prefill runs the bf16 flash kernel at 16
heads, no grouping, dh = 128; its FFN is ``lm._moe_grouped``.

The cells keep every width and cut the batch (``CELL_BATCH``), and
train_4k also the depth:
  * prefill_32k: B = 4, cut from 32.  A sequence of 32,768 positions
    holds 4.29 GB of bf16 KV cache and, in each layer's FFN, its
    (32,768 x 8, 2,048) bf16 expert rows (1.07 GB), copied about three
    times over; B = 4 holds 17.2 GB of cache and about 13 GB of FFN
    rows beside the weights (B = 32 would need 137 GB of cache alone);
    a B = 4 prefill peaked at 52.8 GB on an H100.
  * decode_32k: B = 12, cut from 128: 51.5 GB of bf16 cache beside the
    13.8 GB of weights (B = 16 would be 68.7 GB of cache, 82.5 GB with
    the weights).
  * train_4k: B = 8 sequences of 4,096, cut from 256, in
    ``base.LM_TRAIN_MICRO`` = 2 microbatches of 4 (the JAX cell: 8 of
    32), and the depth cut to ``TRAIN_LAYERS`` of 16.  The reckoning:
    f32 parameters, gradients and AdamW's two moments cost 16 bytes a
    parameter, 110.7 GB at all 16 layers; the untied embedding and
    head take 206.6 M parameters (3.3 GB), a layer 419.6 M (6.7 GB).
    On top, a layer's three expert leaves (134.2 M parameters each)
    get their gradient in the backward pass as full-size (L, E, ...)
    f32 buffers (0.54 GB a leaf a layer of depth), and the layer's bf16
    weight copies (0.8 GB).  On an H100 (80 GB HBM3, 85.0 GB to
    allocate), in a process that first ran the MoE prefills and
    granite's train cell, 7 layers peaked at 69.3 GB allocated and 73.2
    GB reserved, 8 at 77.8 and 82.7 GB, and 10 ran out of memory (a 5.0
    GiB gradient buffer).  8 also ran after every earlier cell of the
    smoke, peaking at 78.2 GB allocated and 82.6 GB reserved (glm4-9b's
    13 layers, at 83.5 GB reserved alone, did not); 9 was not tried,
    since 8 leaves 2.4 GB unreserved.  So 8.  Each layer is
    checkpointed, the routing recomputed with it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "olmoe-1b-7b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "long_500k": "pure full-attention stack (no sub-quadratic path); "
                 "skipped per brief - see DESIGN.md §5",
}
# cut from 32, 128 and 256
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 12, "train_4k": 8}
TRAIN_LAYERS = 8  # of 16: the most whose f32 training state fits
TRAIN_CUTS = {"batch": "256 -> 8", "microbatches": "8 of 32 -> 2 of 4",
              "n_layers": f"16 -> {TRAIN_LAYERS}"}


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=1024, vocab=50304, padded_vocab=50432,
        rope_theta=10_000.0, qk_norm=True,
        moe=lm.MoEConfig(n_experts=64, top_k=8, d_expert=1024),
        tie_embeddings=False,
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=32, vocab=128, padded_vocab=128,
        qk_norm=True, moe=lm.MoEConfig(n_experts=8, top_k=2, d_expert=32),
        tie_embeddings=False, dtype="float32", remat=False,
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
