"""bst [arXiv:1905.06874]: embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq (Alibaba Behavior Sequence
Transformer), at the JAX package's id spaces: a 4M-item table (512 MB
f32), 0.66 GB of f32 weights in all, whole on one card.

All four cells run at the published widths and batches, with nothing
cut: ``serve_p99`` B = 512, ``serve_bulk`` B = 262,144 (its largest
intermediates are the (B, 8, 20, 20) f32 scores, 3.4 GB, and the FFN's
(B, 20, 256), 5.4 GB), ``retrieval_cand`` one user against 1,000,000
candidates in 8 chunks, and ``train_batch`` B = 65,536 (AdamW, lr 1e-3,
about 2.6 GB of weights, moments and gradient).  BST's path has no
kernel, so its training needs no backward kernel: plain autograd runs
it.  Inputs are drawn as the JAX smoke batch draws them (full
histories), at the cell's batch.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import recsys_common as rc
from repro_torch.models.recsys import bst as model

ARCH_ID = "bst"
FAMILY = "recsys"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
SKIPPED_SHAPES: dict = {}
RETRIEVAL_CHUNKS = 8  # candidate chunks, as in the JAX cell


def full_config() -> model.BSTConfig:
    return model.BSTConfig()  # the published numbers are the defaults


def smoke_config() -> model.BSTConfig:
    return model.BSTConfig(item_vocab=500, cat_vocab=20, user_vocab=100,
                           n_user_fields=2, embed_dim=8, seq_len=6,
                           n_heads=4, mlp_hidden=(32, 16, 8))


def init_smoke(gen, cfg, device=None):
    return model.init(gen, cfg, device=device)


def _batch(rng: np.random.Generator, cfg, b: int, device) -> dict:
    """The JAX smoke batch's arrays, drawn in its order."""
    t = cfg.seq_len - 1  # history slots (the target is appended)
    return rc.on(
        device or "cpu",
        hist_ids=rng.integers(0, cfg.item_vocab, (b, t)).astype(np.int32),
        hist_cats=rng.integers(0, cfg.cat_vocab, (b, t)).astype(np.int32),
        hist_mask=np.ones((b, t), np.float32),
        user_fields=rng.integers(0, cfg.user_vocab, (b, cfg.n_user_fields))
        .astype(np.int32),
        item_id=rng.integers(0, cfg.item_vocab, b).astype(np.int32),
        item_cat=rng.integers(0, cfg.cat_vocab, b).astype(np.int32),
        label=rng.integers(0, 2, b).astype(np.float32))


def smoke_batch(rng: np.random.Generator, cfg, device=None) -> dict:
    return _batch(rng, cfg, 16, device)


def smoke_loss(params, cfg, batch):
    return model.loss_fn(params, cfg, batch)


def make_cell(shape: str, cfg: model.BSTConfig | None = None) -> rc.Cell:
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
            flops_fwd=b * model.flops_per_example(cfg))
    if shape == "retrieval_cand":
        n = info["n_candidates"]

        def make_inputs(rng, device):
            user = _batch(rng, cfg, 1, device)
            for k in ("item_id", "item_cat", "label"):
                user.pop(k)
            cand = rc.on(device,
                         ids=rng.integers(0, cfg.item_vocab, n)
                         .astype(np.int32),
                         cats=rng.integers(0, cfg.cat_vocab, n)
                         .astype(np.int32))
            return user, cand["ids"], cand["cats"]

        def fwd(p, user, cid, ccat):
            return model.score_candidates_chunked(
                p, cfg, user, cid, ccat, n_chunks=RETRIEVAL_CHUNKS)

        return rc.make_cell(ARCH_ID, shape, kind="retrieval", fn=fwd,
                            make_params=make_params, make_inputs=make_inputs,
                            flops_fwd=n * model.flops_per_example(cfg))

    def make_inputs(rng, device):
        batch = _batch(rng, cfg, b, device)
        batch.pop("label")
        return (batch,)

    return rc.make_cell(ARCH_ID, shape, kind="serve",
                        fn=lambda p, bb: model.forward(p, cfg, bb),
                        make_params=make_params, make_inputs=make_inputs,
                        flops_fwd=b * model.flops_per_example(cfg))
