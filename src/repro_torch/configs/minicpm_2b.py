"""minicpm-2b [arXiv:2404.06395], the JAX package's config on one card.

40L d_model=2304 36H (kv=36, MHA, d_head=64) d_ff=5760 vocab=122753
(padded to 122,880; the logits are (B, 122,880), as in JAX); llama-like
with minicpm's scales: embeddings x 12, depth-scaled residuals
1.4/sqrt(40), logits divided by d_model / 256.  2,725,173,504
parameters: 10.9 GB in f32, 5.45 GB in bf16.  Its prefill runs the bf16
flash kernel at 36 heads of dh = 64 with no grouping.

The cells keep every width and all 40 layers and cut the batch to what
one 80 GB card holds (``CELL_BATCH``).  With 36 kv heads the bf16 KV
cache is 12.1 GB a sequence of 32,768 positions (2 L S Hkv dh values),
so both cells run B = 4 (48.3 GB of cache): prefill_32k is cut from 32
(386.5 GB of cache), decode_32k from 128 (1,546 GB).  train_4k keeps all
40 layers and is cut from 256 to 8 sequences of 4,096 in
``base.LM_TRAIN_MICRO`` = 2 microbatches of 4 (the JAX cell: 8 of 32):
f32 parameters, gradients and AdamW's two moments take 43.7 GB; each
layer is checkpointed.
"""
from __future__ import annotations

import math

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "minicpm-2b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "long_500k": "pure full-attention stack (no sub-quadratic path); "
                 "skipped per brief - see DESIGN.md §5",
}
# cut from 32, 128 and 256
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 4, "train_4k": 8}
TRAIN_CUTS = {"batch": "256 -> 8", "microbatches": "8 of 32 -> 2 of 4"}


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID, n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_head=64, d_ff=5760, vocab=122753, padded_vocab=122880,
        rope_theta=10_000.0,
        embed_scale=12.0, residual_scale=1.4 / math.sqrt(40.0),
        logit_divisor=2304.0 / 256.0, tie_embeddings=True,
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=72, n_heads=6,
        n_kv_heads=6, d_head=12, d_ff=144, vocab=128, padded_vocab=128,
        embed_scale=12.0, residual_scale=1.4 / math.sqrt(2.0),
        logit_divisor=72.0 / 16.0, dtype="float32", remat=False,
    )


def make_cell(shape: str, cfg: lm.LMConfig | None = None) -> base.Cell:
    return base.lm_cell(ARCH_ID, cfg or full_config(), shape,
                        skipped=SKIPPED_SHAPES, cell_batch=CELL_BATCH,
                        cuts=TRAIN_CUTS)


def init_smoke(gen, cfg, device=None):
    return lm.init(gen, cfg, device)


def smoke_batch(rng, cfg, device=None) -> dict:
    """The JAX package's ``lm_smoke_batch``: 2 sequences of 16 tokens."""
    return base.lm_batch(rng, cfg.vocab, 2, 16, device or "cpu")


def smoke_loss(params, cfg, batch):
    return lm.loss_fn(params, cfg, batch)
