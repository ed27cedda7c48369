"""The port's architecture registry and its single-card cell.

Every ported architecture module exposes the surface of the JAX
package's configs::

    ARCH_ID: str;  FAMILY: "recsys" | "lm" | "gnn";  SHAPES: tuple[str, ...]
    SKIPPED_SHAPES: dict[shape, reason]   (shapes not ported yet)
    full_config() / smoke_config()        model config objects (SchNet's
                                          may take the shape)
    make_cell(shape, cfg=None) -> Cell    (cfg defaults to full_config(),
                                          SchNet's to full_config(shape))
    init_smoke(gen, cfg, device) / smoke_batch(rng, cfg, device)
                                          (recsys; the LM has lm.init)
    smoke_loss(params, cfg, batch)        (every arch that trains: din,
                                          dlrm-rm2, xdeepfm, bst, schnet,
                                          the five LMs,
                                          greenflow-cascade)

A ``Cell`` is one (architecture x shape) on one card: a function and a
way to make its arguments.  It is the single-card counterpart of the JAX
package's ``DryRunCell``: the arguments are tensors drawn from a seed on
a device instead of abstract shapes, and there are no shardings.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable

ARCH_IDS = (
    "granite-moe-1b-a400m", "olmoe-1b-7b", "glm4-9b", "gemma2-2b",
    "minicpm-2b", "schnet", "dlrm-rm2", "din", "xdeepfm", "bst",
    "greenflow-cascade",
)

_MODULES = {
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "xdeepfm": "repro_torch.configs.xdeepfm_arch",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "din": "repro_torch.configs.din_arch",
    "bst": "repro_torch.configs.bst_arch",
    "schnet": "repro_torch.configs.schnet",
    "greenflow-cascade": "repro_torch.configs.greenflow_cascade",
}


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str  # serve | retrieval | prefill | decode | train
    # fn(*make_args(seed, device)) -> (B,) or (B, V) logits; a train
    # cell's fn(state, batch) -> (state, loss)
    fn: Callable
    make_args: Callable  # (seed, device) -> tuple of tensors / dicts
    # model_flops etc.; "outputs" names a cell's outputs when it returns
    # a tuple of tensors (default: its one tensor of logits)
    meta: dict = field(default_factory=dict)


# the JAX package's LM shapes (repro/configs/base.py); a config module
# cuts the batch to what one card holds and says so
LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """``meta["model_flops"]`` of an LM cell, as the JAX cells count it:
    2 N per token in prefill; 2 N per sequence plus reading the
    (K, V) cache's 2 L S Hkv dh values twice in decode."""
    n = cfg.n_active_params()
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return (2.0 * n * batch
            + 2.0 * cfg.n_layers * batch * seq * cfg.n_kv_heads
            * cfg.d_head * 2)


def lm_make_cell(arch_id: str, cfg, shape: str, *, batch: int,
                 seq: int) -> Cell:
    """A prefill or decode cell of ``cfg`` at ``batch`` sequences of
    ``seq`` positions.  ``make_args(seed, device)`` draws the weights on
    the device (``lm.init``) and casts them to the compute dtype once;
    prefill takes (params, tokens (B, seq)), decode (params, token (B,),
    cache) with a cache of ``seq`` positions drawn on the device and
    ``length = seq - 1``, so every call starts from the same state.
    ``fn`` returns the (B, V) logits."""
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    kind = LM_SHAPES[shape]["kind"]

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = lm.init(gen, cfg, device)
        params = lm.cast_params(params, cfg.compute_dtype)
        rng = np.random.default_rng(seed)
        if kind == "prefill":
            toks = rng.integers(0, cfg.vocab, (batch, seq))
            return params, torch.from_numpy(toks).to(device)
        token = torch.from_numpy(rng.integers(0, cfg.vocab, batch)).to(device)
        cache = lm.init_cache(cfg, batch, seq, device=device)
        g = L.device_generator(gen, device)
        for buf in (cache["k"], cache["v"]):
            for i in range(cfg.n_layers):  # one layer's f32 draw at a time
                buf[i] = torch.randn(buf.shape[1:], generator=g,
                                     device=device)
        cache["length"] = seq - 1
        return params, token, cache

    if kind == "prefill":
        def fn(params, tokens):
            return lm.prefill(params, cfg, tokens, max_len=seq)[0]
    else:
        def fn(params, token, cache):
            return lm.decode_step(params, cfg, token, cache)[0]

    return Cell(arch_id=arch_id, shape_name=shape, kind=kind, fn=fn,
                make_args=make_args,
                meta={"model_flops": lm_model_flops(cfg, kind, batch, seq),
                      "batch": batch, "seq": seq})


LM_SMOKE_BATCH, LM_SMOKE_SEQ = 2, 64  # an LM cell at the smoke widths
LM_TRAIN_LR = 3e-4  # the JAX lm_train_cell's AdamW (weight decay 0.1)
LM_TRAIN_MICRO = 2  # microbatches of a train_4k cell (B = 8: 2 of 4)


def lm_batch(rng, vocab: int, batch: int, seq: int, device) -> dict:
    """The JAX package's LM training batch: ``batch`` rows of ``seq + 1``
    uniform tokens, tokens the first ``seq``, targets the last ``seq``,
    mask ones (``lm_smoke_batch``'s draw)."""
    import numpy as np
    import torch

    toks = rng.integers(0, vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "targets": toks[:, 1:].astype(np.int32),
           "mask": np.ones((batch, seq), np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def lm_train_cell(arch_id: str, cfg, shape: str, *, batch: int, seq: int,
                  cuts: dict) -> Cell:
    """The JAX package's ``lm_train_cell`` on one card: ``batch``
    sequences of ``seq`` positions (``lm_batch``), the gradient of
    ``lm.loss_fn`` averaged over ``LM_TRAIN_MICRO`` microbatches in a
    Python loop
    (``trainer.micro_value_and_grad``), then one AdamW step (weight decay
    0.1, lr 3e-4, no clipping).  ``make_args(seed, device)`` -> (a
    ``TrainState`` of ``lm.init``'s f32 parameters, the batch);
    ``fn(state, batch) -> (state, loss)`` updates the state in place (the
    JAX cell donates it).  ``meta``: ``model_flops`` = 6 x active
    parameters x tokens at ``cfg``'s depth, and every cut of the JAX
    cell in ``cuts`` (what -> "JAX value -> this cell's")."""
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.trainer import (TrainState, init_state,
                                              micro_value_and_grad)

    opt = AdamW(weight_decay=0.1)

    def loss(params, mb):
        return lm.loss_fn(params, cfg, mb)

    def step(state: TrainState, data: dict):
        l, grads = micro_value_and_grad(loss, state.params, data,
                                        LM_TRAIN_MICRO)
        params, opt_state = opt.update_(grads, state.opt_state,
                                        state.params, LM_TRAIN_LR)
        return TrainState(state.step + 1, params, opt_state), l

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        params = lm.init(torch.Generator().manual_seed(seed), cfg, device)
        return (init_state(params, opt),
                lm_batch(np.random.default_rng(seed), cfg.vocab, batch, seq,
                         device))

    n_tokens = batch * seq
    return Cell(arch_id=arch_id, shape_name=shape, kind="train", fn=step,
                make_args=make_args,
                meta={"model_flops": 6.0 * cfg.n_active_params() * n_tokens,
                      "n_tokens": n_tokens,
                      "n_microbatches": LM_TRAIN_MICRO,
                      "batch": batch, "seq": seq, "n_layers": cfg.n_layers,
                      "cuts": dict(cuts)})


def lm_cell(arch_id: str, cfg, shape: str, *, skipped: dict,
            cell_batch: dict, cuts: dict | None = None) -> Cell:
    """An LM config module's ``make_cell``: for the full widths, the
    module's cut batch (``cell_batch``) at the shape's positions (32,768;
    4,096 for train_4k); for the smoke widths (a config named
    ``*-smoke``) (LM_SMOKE_BATCH, LM_SMOKE_SEQ).  Prefill and decode go to
    ``lm_make_cell``, train_4k to ``lm_train_cell`` with the module's
    ``cuts``.  A shape in ``skipped``
    raises NotImplementedError with its reason."""
    if shape in skipped:
        raise NotImplementedError(f"{shape}: {skipped[shape]}")
    if shape not in cell_batch:
        raise KeyError(f"unknown shape {shape!r}; have "
                       f"{sorted({*skipped, *cell_batch})}")
    if cfg.name.endswith("-smoke"):
        batch, seq = LM_SMOKE_BATCH, LM_SMOKE_SEQ
    else:
        batch, seq = cell_batch[shape], LM_SHAPES[shape]["seq"]
    if LM_SHAPES[shape]["kind"] == "train":
        return lm_train_cell(arch_id, cfg, shape, batch=batch, seq=seq,
                             cuts=cuts or {})
    return lm_make_cell(arch_id, cfg, shape, batch=batch, seq=seq)


def registered_shapes() -> tuple[str, ...]:
    """Every shape a ported architecture names, run or skipped."""
    names = set()
    for arch_id in _MODULES:
        mod = get_arch(arch_id)
        names.update(mod.SHAPES, getattr(mod, "SKIPPED_SHAPES", {}))
    return tuple(sorted(names))


def get_arch(arch_id: str):
    """The config module of an architecture; every architecture of the
    JAX package is ported."""
    if arch_id in _MODULES:
        return importlib.import_module(_MODULES[arch_id])
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
