"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80 interaction=target-attn, at the JAX package's production
id spaces (10M items, 100K categories, 1M user-field rows: a 720 MB f32
item table), whole on one card.  DIN is also the paper cascade's rank
model.

``train_batch`` is the JAX cell's step (AdamW, lr 1e-3, no clipping) at
B = 65,536: one ``target_attention`` and one ``target_attention_bwd``
launch a step.  Its histories are full (mask 1), as in the smoke batch.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import recsys_common as rc
from repro_torch.models.recsys import din as model

ARCH_ID = "din"
FAMILY = "recsys"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
SKIPPED_SHAPES: dict = {}
RETRIEVAL_CHUNKS = 16  # candidate chunks, as in the JAX cell


def full_config() -> model.DINConfig:
    return model.DINConfig(item_vocab=10_000_000, cat_vocab=100_000,
                           user_vocab=1_000_000, n_user_fields=2,
                           embed_dim=18, seq_len=100,
                           attn_hidden=(80, 40), mlp_hidden=(200, 80))


def smoke_config() -> model.DINConfig:
    return model.DINConfig(item_vocab=500, cat_vocab=20, user_vocab=200,
                           n_user_fields=2, embed_dim=8, seq_len=12,
                           attn_hidden=(16, 8), mlp_hidden=(32, 16))


def init_smoke(gen, cfg, device=None):
    return model.init(gen, cfg, device=device)


def _user(rng: np.random.Generator, cfg, b: int) -> dict:
    t = cfg.seq_len
    return dict(
        hist_ids=rng.integers(0, cfg.item_vocab, (b, t)).astype(np.int32),
        hist_cats=rng.integers(0, cfg.cat_vocab, (b, t)).astype(np.int32),
        hist_mask=np.ones((b, t), np.float32),
        user_fields=rng.integers(0, cfg.user_vocab, (b, cfg.n_user_fields))
        .astype(np.int32))


def _batch(rng: np.random.Generator, cfg, b: int, device) -> dict:
    """The JAX smoke batch's arrays, drawn in its order."""
    return rc.on(device or "cpu", **_user(rng, cfg, b),
                 item_id=rng.integers(0, cfg.item_vocab, b).astype(np.int32),
                 item_cat=rng.integers(0, cfg.cat_vocab, b).astype(np.int32),
                 label=rng.integers(0, 2, b).astype(np.float32))


def smoke_batch(rng: np.random.Generator, cfg, device=None) -> dict:
    return _batch(rng, cfg, 16, device)


def smoke_loss(params, cfg, batch):
    return model.loss_fn(params, cfg, batch)


def make_cell(shape: str, cfg: model.DINConfig | None = None) -> rc.Cell:
    cfg = cfg or full_config()
    info = rc.check_shape(shape)
    b = info["batch"]

    def make_params(gen, device):
        return model.init(gen, cfg, device=device)

    if shape == "train_batch":
        return rc.train_cell(
            ARCH_ID, shape, loss_fn=lambda p, bb: model.loss_fn(p, cfg, bb),
            make_params=make_params,
            make_batch=lambda rng, device: _batch(rng, cfg, b, device),
            flops_fwd=b * model.flops_per_item(cfg))
    if shape == "retrieval_cand":
        n = info["n_candidates"]

        def make_inputs(rng, device):
            cand = rc.on(device,
                         ids=rng.integers(0, cfg.item_vocab, n)
                         .astype(np.int32),
                         cats=rng.integers(0, cfg.cat_vocab, n)
                         .astype(np.int32))
            return (rc.on(device, **_user(rng, cfg, 1)), cand["ids"],
                    cand["cats"])

        def fwd(p, user, cid, ccat):
            return model.score_candidates_chunked(
                p, cfg, user, cid, ccat, n_chunks=RETRIEVAL_CHUNKS)

        return rc.make_cell(ARCH_ID, shape, kind="retrieval", fn=fwd,
                            make_params=make_params, make_inputs=make_inputs,
                            flops_fwd=n * model.flops_per_item(cfg))

    def make_inputs(rng, device):
        batch = _batch(rng, cfg, b, device)
        batch.pop("label")
        return (batch,)

    return rc.make_cell(ARCH_ID, shape, kind="serve",
                        fn=lambda p, bb: model.forward(p, cfg, bb),
                        make_params=make_params, make_inputs=make_inputs,
                        flops_fwd=b * model.flops_per_item(cfg))
