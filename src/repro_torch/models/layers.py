"""Plain-function layers on tensors, parameters as nested dicts.

Each layer is a pair ``<name>_init(gen, ...) -> params`` /
``<name>_apply(params, x) -> y``, with the same parameter layout as the
JAX package (``{"w", "b"}``, ``{"layers": [...]}``, ``{"table"}``), so
``repro_torch.bridge`` carries trained JAX weights over leaf by leaf.
Inits draw from an explicit ``torch.Generator`` on the CPU and move the
result to ``device``, so one seed gives the same weights on any device.
The exception is a table too large to pass through host memory (DLRM's
78M x 64 rows): ``normal_table`` draws it on its device in row chunks,
from a generator on that device (``device_generator``), so the same seed
gives another table on the CPU than on the card.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves

Params = dict


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def lecun_normal(gen, shape, dtype=torch.float32, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return (_randn(gen, shape) / math.sqrt(max(1, fan_in))).to(dtype)


def glorot_uniform(gen, shape, dtype=torch.float32):
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * limit).to(dtype)


def normal_init(gen, shape, std=0.02, dtype=torch.float32):
    return (std * _randn(gen, shape)).to(dtype)


def device_generator(gen, device) -> torch.Generator:
    """A generator on ``device``, seeded by one draw from ``gen``."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def normal_table(gen, rows: int, dim: int, *, std: float,
                 dtype=torch.float32, chunk_rows: int = 1 << 22):
    """(rows, dim) N(0, std^2) table drawn on ``gen``'s device, one chunk
    of ``chunk_rows`` rows at a time: the f32 draw of one chunk is the
    only temporary, so a table of many GB never passes through host
    memory nor through a whole-size f32 copy before its cast."""
    out = torch.empty((rows, dim), dtype=dtype, device=gen.device)
    for r0 in range(0, rows, chunk_rows):
        n = min(chunk_rows, rows - r0)
        out[r0:r0 + n] = std * torch.randn((n, dim), generator=gen,
                                           device=gen.device,
                                           dtype=torch.float32)
    return out


def to_device(tree, device):
    """Move every tensor of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


# -- dense / MLP ------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, *, use_bias: bool = True,
               init: Callable = lecun_normal,
               dtype=torch.float32) -> Params:
    p = {"w": init(gen, (d_in, d_out), dtype)}
    if use_bias:
        p["b"] = torch.zeros(d_out, dtype=dtype)
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


def sigmoid_bce(logits, labels):
    """Mean binary cross-entropy of logits, in the JAX package's form
    max(s, 0) - s y + log1p(exp(-|s|))."""
    y = labels.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


# -- norms -------------------------------------------------------------------


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm_apply(params: Params, x, *, eps: float = 1e-6):
    """LayerNorm over the last axis with the JAX package's eps (1e-6, not
    torch's 1e-5) and its biased variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm_apply(params: Params, x, *, eps: float = 1e-6,
                  zero_centered: bool = False):
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype; ``zero_centered`` scales by (1 + scale), as gemma does."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if zero_centered:
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


# -- misc -------------------------------------------------------------------


def count_params(params) -> int:
    return sum(int(p.numel()) for p in leaves(params))


def global_norm(tree):
    """sqrt of the sum of the leaves' f32 squares, summed in JAX's leaf
    order (``repro_torch.tree``)."""
    return torch.sqrt(sum(p.float().square().sum() for p in leaves(tree)))


def param_bytes(params) -> int:
    return sum(int(p.numel() * p.element_size()) for p in leaves(params))
