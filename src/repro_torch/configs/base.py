"""The port's architecture registry and its single-card cell.

Every ported architecture module exposes the surface of the JAX
package's configs::

    ARCH_ID: str;  FAMILY: "recsys";  SHAPES: tuple[str, ...]
    SKIPPED_SHAPES: dict[shape, reason]   (shapes not ported yet)
    full_config() / smoke_config()        model config objects
    make_cell(shape, cfg=None) -> Cell    (cfg defaults to full_config())
    init_smoke(gen, cfg, device) / smoke_batch(rng, cfg, device)

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
}

_LM = "the LM slice: models/lm.py with flash_attention (ROADMAP queue B6)"
_WAITING = {
    "granite-moe-1b-a400m": _LM, "olmoe-1b-7b": _LM, "glm4-9b": _LM,
    "gemma2-2b": _LM, "minicpm-2b": _LM,
    "schnet": "the model zoo (ROADMAP queue A item 13: models/gnn)",
    "din": "the model zoo (ROADMAP queue A item 13: configs/din_arch)",
    "bst": "the model zoo (ROADMAP queue A item 13: models/recsys/bst)",
    "greenflow-cascade": "the model zoo (ROADMAP queue A item 13: "
                         "configs/greenflow_cascade)",
}


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str  # serve | retrieval
    fn: Callable  # fn(*make_args(seed, device)) -> (B,) logits
    make_args: Callable  # (seed, device) -> tuple of tensors / dicts
    meta: dict = field(default_factory=dict)  # model_flops etc.


def get_arch(arch_id: str):
    """The config module of a ported architecture.  An architecture of
    the JAX package that is not ported yet raises NotImplementedError
    naming the ROADMAP item that ports it."""
    if arch_id in _MODULES:
        return importlib.import_module(_MODULES[arch_id])
    if arch_id in _WAITING:
        raise NotImplementedError(f"{arch_id!r} is not ported yet; it "
                                  f"comes with {_WAITING[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
