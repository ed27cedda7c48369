"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base], the
JAX package's config on one card.

24L d_model=1024 16H (GQA kv=8, d_head=64) vocab=49155 (padded to
49,408; the logits are (B, 49,408), as in JAX); a MoE FFN of 32 experts,
top 8, d_expert=512 (SwiGLU), a tied head.  1,334,887,424 parameters
(1.21 B of them in the experts), 428,868,608 active a token: 5.3 GB in
f32 as ``init`` draws them, 2.7 GB in bf16 as the cells serve them.  Its
prefill runs the bf16 flash kernel at 16 query heads on 8 kv heads, dh
= 64; its FFN is ``lm._moe_grouped`` (tokens grouped by expert, one
product an expert, one host read of the per-expert counts a layer).

The cells keep every width and all 24 layers and cut the batch
(``CELL_BATCH``):
  * prefill_32k: B = 4, cut from 32.  A sequence of 32,768 positions
    holds 1.61 GB of bf16 KV cache (2 L S Hkv dh values) and, in each
    layer's FFN, its (32,768 x 8, 1,024) bf16 expert rows (0.54 GB),
    copied about three times over (the rows, the experts' outputs and
    their inverse permutation).  B = 32 would hold 51.5 GB of cache
    and about 52 GB of FFN rows at once.  B = 4, the dense LMs' prefill
    batch, holds 6.4 GB and 6.4 GB and peaked at 19.5 GB on an H100;
    a batch up to about 16 would fit, but a B = 4 call takes about 1.5
    s there, and the cells' calls in ``chip_smoke.py`` share its time
    limit with every other phase.
  * decode_32k: B = 32, cut from 128: 51.5 GB of bf16 cache beside the
    weights (B = 128 would be 206.2 GB).
  * train_4k: B = 8 sequences of 4,096, cut from 256, in
    ``base.LM_TRAIN_MICRO`` = 2 microbatches of 4 (the JAX cell: 8 of
    32), all 24 layers: f32 parameters, gradients and AdamW's two
    moments take 21.4 GB (16 bytes a parameter); a layer's expert
    leaves (w1, w2, w3: 3 x 16.8 M parameters) get their gradient as a
    full-size (L, E, ...) f32 buffer each in the backward pass, 4.8 GB
    at once.  Each layer is checkpointed, the routing recomputed with
    it.
"""
from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models import lm

ARCH_ID = "granite-moe-1b-a400m"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPPED_SHAPES = {
    "long_500k": "pure full-attention stack (no sub-quadratic path); "
                 "skipped per brief - see DESIGN.md §5",
}
# cut from 32, 128 and 256
CELL_BATCH = {"prefill_32k": 4, "decode_32k": 32, "train_4k": 8}
TRAIN_CUTS = {"batch": "256 -> 8", "microbatches": "8 of 32 -> 2 of 4"}


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID, n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_head=64, d_ff=512, vocab=49155, padded_vocab=49408,
        rope_theta=10_000.0,
        moe=lm.MoEConfig(n_experts=32, top_k=8, d_expert=512),
        tie_embeddings=True,
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=32, vocab=128, padded_vocab=128,
        moe=lm.MoEConfig(n_experts=4, top_k=2, d_expert=32),
        dtype="float32", remat=False,
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
