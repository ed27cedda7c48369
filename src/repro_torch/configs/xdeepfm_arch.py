"""xdeepfm [arXiv:1803.05170]: n_sparse=39 embed_dim=10
cin_layers=200-200-200 mlp=400-400 interaction=CIN.  Stacked table of
79,984,968 rows x 10 (1.6 GB in bf16) plus the linear table, whole on
one card.  ``train_batch`` is the JAX cell's hybrid step at B = 65,536,
no cut: SGD (0.04) on the table and the linear table, AdamW (1e-3) on
the CIN and DNN weights; three ``cin_layer`` and three ``cin_layer_bwd``
launches a step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import recsys_common as rc
from repro_torch.models.recsys import xdeepfm as model

ARCH_ID = "xdeepfm"
FAMILY = "recsys"
SHAPES = rc.SHAPES
SKIPPED_SHAPES: dict = {}
EMB_KEYS = ("tables", "linear")  # trained by the hybrid step's SGD

PAD_TO = 1024
N_ITEM_FIELDS = 6
RETRIEVAL_CHUNKS = 32  # candidate chunks, as in the JAX cell


def full_config() -> model.XDeepFMConfig:
    return model.XDeepFMConfig()


def smoke_config() -> model.XDeepFMConfig:
    return model.XDeepFMConfig(vocab_sizes=tuple([32] * 39), embed_dim=4,
                               cin_layers=(8, 8), mlp_hidden=(16, 16))


def init_smoke(gen, cfg, device=None):
    return model.init(gen, cfg, device=device)


def smoke_batch(rng: np.random.Generator, cfg, device=None) -> dict:
    b = 16
    return rc.on(device or "cpu",
                 sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b),
                 label=rng.integers(0, 2, b).astype(np.float32))


def smoke_loss(params, cfg, batch):
    return model.loss_fn(params, cfg, batch)


def make_cell(shape: str,
              cfg: model.XDeepFMConfig | None = None) -> rc.Cell:
    cfg = cfg or full_config()
    info = rc.check_shape(shape)

    def make_params(gen, device):
        return model.init(gen, cfg, pad_vocab_to=PAD_TO, device=device)

    if shape == "train_batch":
        b = info["batch"]

        def make_batch(rng, device):
            return rc.on(device,
                         sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b),
                         label=rng.integers(0, 2, b).astype(np.float32))

        return rc.hybrid_train_cell(
            ARCH_ID, shape, loss_fn=lambda p, bb: model.loss_fn(p, cfg, bb),
            make_params=make_params, make_batch=make_batch,
            flops_fwd=b * model.flops_per_example(cfg), emb_keys=EMB_KEYS)

    if shape == "retrieval_cand":
        n = info["n_candidates"]

        def make_inputs(rng, device):
            user = rc.on(device,
                         sparse=rc.sparse_ids(rng, cfg.vocab_sizes, 1))
            cand = rc.sparse_ids(rng, cfg.vocab_sizes[-N_ITEM_FIELDS:], n)
            return user, rc.on(device, cand=cand)["cand"]

        def fwd(p, user, cand):
            # candidate chunks bound the live CIN layer (8 GB in f32 for
            # the whole million)
            cs = -(-cand.shape[0] // RETRIEVAL_CHUNKS)
            return torch.cat([model.retrieval_forward(p, cfg, user, c)
                              for c in torch.split(cand, cs)])

        return rc.make_cell(ARCH_ID, shape, kind="retrieval", fn=fwd,
                            make_params=make_params, make_inputs=make_inputs,
                            flops_fwd=n * model.flops_per_example(cfg))

    b = info["batch"]

    def make_inputs(rng, device):
        return (rc.on(device,
                      sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b)),)

    def fwd(p, batch):
        return model.forward(p, cfg, batch)

    return rc.make_cell(ARCH_ID, shape, kind="serve", fn=fwd,
                        make_params=make_params, make_inputs=make_inputs,
                        flops_fwd=b * model.flops_per_example(cfg))
