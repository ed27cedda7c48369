"""gemma2-2b [arXiv:2408.00118], the JAX package's config on one card.

26L d_model=2304 8H (GQA kv=4, d_head=256) d_ff=9216 vocab=256000;
local(4096)/global alternating attention, attn softcap 50 / final softcap
30, GeGLU, zero-centered RMSNorm, sandwich norms, embeddings scaled by
sqrt(d_model).  2,614,341,888 parameters: 10.46 GB in f32 as ``init``
draws them, 5.23 GB in bf16 as the cells serve them.

The cells keep every width and all 26 layers and cut the batch to what
one 80 GB card holds (``CELL_BATCH``): the bf16 KV cache is 3.49 GB per
32,768-position sequence, so the JAX cells' B = 32 prefill (111.7 GB)
and B = 128 decode (446.7 GB) do not fit.  train_4k is cut from 256 to
8 sequences of 4,096 in ``base.LM_TRAIN_MICRO`` = 2 microbatches of 4
(the JAX cell: 4 of 64): f32 parameters, gradients and AdamW's two
moments take 41.8 GB, and the f32 logits 4.2 GB a sequence (formed 2,048
positions at a time, ``lm.LOSS_CHUNK``); each layer is checkpointed.  At
the smoke widths a cell runs ``SMOKE_BATCH`` sequences of ``SMOKE_SEQ``
positions, which the CPU can hold.
"""
from __future__ import annotations

import math

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "gemma2-2b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "long_500k": "the 524,288-position decode is not ported yet (ROADMAP "
                 "queue A item 18: a 55.8 GB bf16 cache at B = 1)",
}
# cut from 32, 128 and 256
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 8, "train_4k": 8}
TRAIN_CUTS = {"batch": "256 -> 8", "microbatches": "4 of 64 -> 2 of 4"}
SMOKE_BATCH, SMOKE_SEQ = base.LM_SMOKE_BATCH, base.LM_SMOKE_SEQ


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID, n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_head=256, d_ff=9216, vocab=256000, padded_vocab=256000,
        rope_theta=10_000.0,
        window_pattern=(4096, -1),  # local, global, local, ...
        attn_softcap=50.0, final_softcap=30.0,
        sandwich_norm=True, zero_centered_norm=True, act="gelu",
        embed_scale=math.sqrt(2304.0), query_scale=1.0 / math.sqrt(256.0),
        tie_embeddings=True,
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=128, padded_vocab=128,
        window_pattern=(8, -1), attn_softcap=50.0, final_softcap=30.0,
        sandwich_norm=True, zero_centered_norm=True, act="gelu",
        embed_scale=8.0, dtype="float32", remat=False,
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
