"""Plain-function layers on tensors, parameters as nested dicts.

Each layer is a pair ``<name>_init(gen, ...) -> params`` /
``<name>_apply(params, x) -> y``, with the same parameter layout as the
JAX package (``{"w", "b"}``, ``{"layers": [...]}``, ``{"table"}``), so
``repro_torch.bridge`` carries trained JAX weights over leaf by leaf.
Inits draw from an explicit ``torch.Generator`` on the CPU and move the
result to ``device``, so one seed gives the same weights on any device.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

Params = dict


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def lecun_normal(gen, shape, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _randn(gen, shape) / math.sqrt(max(1, fan_in))


def glorot_uniform(gen, shape):
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def normal_init(gen, shape, std=0.02):
    return std * _randn(gen, shape)


def to_device(tree, device):
    """Move every tensor of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


# -- dense / MLP ------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, *, use_bias: bool = True,
               init: Callable = lecun_normal) -> Params:
    p = {"w": init(gen, (d_in, d_out))}
    if use_bias:
        p["b"] = torch.zeros(d_out)
    return p


def dense_apply(params: Params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "none": lambda x: x,
    None: lambda x: x,
}


def activation(name):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def mlp_init(gen, dims: Sequence[int], *, use_bias: bool = True) -> Params:
    """dims = [d_in, h1, ..., d_out]."""
    return {"layers": [dense_init(gen, dims[i], dims[i + 1],
                                  use_bias=use_bias)
                       for i in range(len(dims) - 1)]}


def mlp_apply(params: Params, x, *, act: str = "relu",
              final_act: str = "none"):
    n = len(params["layers"])
    act_fn, final_fn = activation(act), activation(final_act)
    for i, layer in enumerate(params["layers"]):
        x = dense_apply(layer, x)
        x = final_fn(x) if i == n - 1 else act_fn(x)
    return x


# -- embedding / PReLU -------------------------------------------------------


def embedding_init(gen, vocab: int, dim: int, *, std: float = 0.02):
    return {"table": normal_init(gen, (vocab, dim), std)}


def embedding_apply(params: Params, ids):
    return params["table"][ids.long()]


def prelu_init(d: int) -> Params:
    return {"alpha": 0.25 * torch.ones(d)}


def prelu_apply(params: Params, x):
    return torch.where(x >= 0, x, params["alpha"] * x)
