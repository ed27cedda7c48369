"""dlrm-rm2 [arXiv:1906.00091]: n_dense=13 n_sparse=26 embed_dim=64
bot=13-512-256-64 top=512-512-256-1 interaction=dot.  Criteo-scale
stacked table (78,046,168 rows x 64, 10.0 GB in bf16), whole on one
card.  ``train_batch`` is the JAX cell's hybrid step at B = 65,536, no
cut: SGD (0.04) on the table, AdamW (1e-3) on the MLPs; one
``dot_interact`` and one ``dot_interact_bwd`` launch a step.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import recsys_common as rc
from repro_torch.models.recsys import dlrm as model

ARCH_ID = "dlrm-rm2"
FAMILY = "recsys"
SHAPES = rc.SHAPES
SKIPPED_SHAPES: dict = {}
EMB_KEYS = ("tables",)  # trained by the hybrid step's SGD

PAD_TO = 1024  # table rows pad to a multiple of this, as in the JAX cells
N_ITEM_FIELDS = 4  # trailing sparse fields swapped per retrieval candidate


def full_config() -> model.DLRMConfig:
    return model.DLRMConfig()


def smoke_config() -> model.DLRMConfig:
    return model.DLRMConfig(vocab_sizes=tuple([64] * 26), embed_dim=8,
                            bot_mlp=(32, 16, 8), top_mlp=(64, 32, 1),
                            top_pad=512)


def init_smoke(gen, cfg, device=None):
    return model.init(gen, cfg, device=device)


def _dense(rng, cfg, n):
    return rng.normal(size=(n, cfg.n_dense)).astype(np.float32)


def smoke_batch(rng: np.random.Generator, cfg, device=None) -> dict:
    b = 16
    return rc.on(device or "cpu", dense=_dense(rng, cfg, b),
                 sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b),
                 label=rng.integers(0, 2, b).astype(np.float32))


def smoke_loss(params, cfg, batch):
    return model.loss_fn(params, cfg, batch)


def make_cell(shape: str, cfg: model.DLRMConfig | None = None) -> rc.Cell:
    cfg = cfg or full_config()
    info = rc.check_shape(shape)

    def make_params(gen, device):
        return model.init(gen, cfg, pad_vocab_to=PAD_TO, device=device)

    if shape == "train_batch":
        b = info["batch"]

        def make_batch(rng, device):
            return rc.on(device, dense=_dense(rng, cfg, b),
                         sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b),
                         label=rng.integers(0, 2, b).astype(np.float32))

        return rc.hybrid_train_cell(
            ARCH_ID, shape, loss_fn=lambda p, bb: model.loss_fn(p, cfg, bb),
            make_params=make_params, make_batch=make_batch,
            flops_fwd=b * model.flops_per_example(cfg), emb_keys=EMB_KEYS)

    if shape == "retrieval_cand":
        n = info["n_candidates"]

        def make_inputs(rng, device):
            user = rc.on(device, dense=_dense(rng, cfg, 1),
                         sparse=rc.sparse_ids(rng, cfg.vocab_sizes, 1))
            cand = rc.sparse_ids(rng, cfg.vocab_sizes[-N_ITEM_FIELDS:], n)
            return user, rc.on(device, cand=cand)["cand"]

        def fwd(p, user, cand):
            return model.retrieval_forward(p, cfg, user, cand)

        return rc.make_cell(ARCH_ID, shape, kind="retrieval", fn=fwd,
                            make_params=make_params, make_inputs=make_inputs,
                            flops_fwd=n * model.flops_per_example(cfg))

    b = info["batch"]

    def make_inputs(rng, device):
        return (rc.on(device, dense=_dense(rng, cfg, b),
                      sparse=rc.sparse_ids(rng, cfg.vocab_sizes, b)),)

    def fwd(p, batch):
        return model.forward(p, cfg, batch)

    return rc.make_cell(ARCH_ID, shape, kind="serve", fn=fwd,
                        make_params=make_params, make_inputs=make_inputs,
                        flops_fwd=b * model.flops_per_example(cfg))
