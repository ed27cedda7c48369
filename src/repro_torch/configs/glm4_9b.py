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
"""
from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "glm4-9b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "train_4k": "training waits for the backward kernels of both flash "
                "attention kernels (ROADMAP queue A item 25)",
    "long_500k": "pure full-attention stack (no sub-quadratic path); "
                 "skipped per brief - see DESIGN.md §5",
}
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 32}  # cut from 32 and 128


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
    )


def make_cell(shape: str, cfg: lm.LMConfig | None = None) -> base.Cell:
    return base.lm_cell(ARCH_ID, cfg or full_config(), shape,
                        skipped=SKIPPED_SHAPES, cell_batch=CELL_BATCH)
