"""SchNet (Schuett et al. [arXiv:1706.08566]) - continuous-filter
convolutional network.

Published config: n_interactions=3, d_hidden=64, rbf=300, cutoff=10.

Message passing is edge-parallel, as in the JAX package: gather source
features, modulate them with the RBF-filter network, and sum them into
their destinations (``jax.ops.segment_sum`` there, ``index_add`` here).
On the card ``index_add`` sums by atomics in no fixed order, so two
identical steps need not agree bit for bit: hold SchNet to a tolerance.

Edges in chunks, with recompute.  Each interaction forms its messages
``edge_chunk`` edges at a time: RBF expansion -> filter MLP -> ssp * cut
* edge_mask -> h[src] * w -> ``index_add`` into the (N, d) aggregate.
Under autograd each chunk runs inside ``torch.utils.checkpoint``, so the
backward recomputes the chunk's intermediates instead of keeping them.
Without it ogbn-products (61.9 M edges) does not fit one card: its
(E, 300) f32 RBF expansion alone is 74 GB.  The RBF and the cutoff are
therefore computed per interaction and chunk from the distances (the
JAX package computes them once for all interactions; the numbers are
the same).  A graph of at most ``edge_chunk`` edges runs as one chunk,
without the checkpoint.

Two task heads:
  * graph_reg   - per-graph energy (molecule batches; segment-sum readout),
  * node_class  - per-node logits (full_graph_sm / ogb_products /
    minibatch_lg citation-style graphs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

EDGE_CHUNK = 1 << 22  # edges a chunk: a 5 GB f32 RBF expansion at n_rbf 300


def ssp(x):
    """Shifted softplus - SchNet's activation.  ``logaddexp(x, 0)`` is
    ``jax.nn.softplus`` itself (``F.softplus`` turns into the identity
    above 20)."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


@dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat: int = 0  # >0: project node features; 0: embed atom types
    n_atom_types: int = 100
    n_out: int = 1  # 1 for graph_reg; n_classes for node_class
    task: str = "graph_reg"  # graph_reg | node_class
    readout_hidden: int = 32


def init(gen: torch.Generator, cfg: SchNetConfig, device=None) -> dict:
    d = cfg.d_hidden
    if cfg.d_feat > 0:
        inp = {"proj": L.dense_init(gen, cfg.d_feat, d)}
    else:
        inp = {"embed": L.embedding_init(gen, cfg.n_atom_types, d)}
    blocks = [{
        "filter": L.mlp_init(gen, [cfg.n_rbf, d, d]),
        "in_proj": L.dense_init(gen, d, d, use_bias=False),
        "out1": L.dense_init(gen, d, d),
        "out2": L.dense_init(gen, d, d),
    } for _ in range(cfg.n_interactions)]
    return L.to_device({
        **inp,
        "blocks": blocks,
        "head1": L.dense_init(gen, d, cfg.readout_hidden),
        "head2": L.dense_init(gen, cfg.readout_hidden, cfg.n_out),
    }, device or "cpu")


def rbf_expand(dist, cfg: SchNetConfig):
    """dist (E,) -> (E, n_rbf) Gaussian radial basis on [0, cutoff]."""
    mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=torch.float32,
                        device=dist.device)
    gamma = 1.0 / (mu[1] - mu[0]) ** 2
    r = dist[:, None] - mu[None, :]
    if dist.requires_grad:
        return torch.exp(-gamma * r.square())
    return r.square_().mul_(-gamma).exp_()  # one (E, n_rbf) buffer


def cosine_cutoff(dist, cfg: SchNetConfig):
    c = 0.5 * (torch.cos(math.pi * dist / cfg.cutoff) + 1.0)
    return torch.where(dist < cfg.cutoff, c, 0.0)


def _aggregate(block, cfg: SchNetConfig, h, src, dst, dist, edge_mask,
               n_nodes: int):
    """The (N, d) sum over these edges of h[src] * filter(dist) into dst."""
    w = L.mlp_apply(block["filter"], rbf_expand(dist, cfg), act="none",
                    final_act="none")
    w = ssp(w) * cosine_cutoff(dist, cfg)[:, None] * edge_mask[:, None]
    msg = h.index_select(0, src) * w  # (E, d) gather + modulate
    return torch.zeros((n_nodes, msg.shape[1]), dtype=msg.dtype,
                       device=msg.device).index_add(0, dst, msg)


def interaction(block, cfg: SchNetConfig, x, src, dst, dist, edge_mask,
                n_nodes: int, *, edge_chunk: int = EDGE_CHUNK):
    """One cfconv + atom-wise block. x (N, d); src/dst (E,) int32; the
    messages formed ``edge_chunk`` edges at a time (module docstring)."""
    h = L.dense_apply(block["in_proj"], x)
    e = src.shape[0]
    if e <= edge_chunk:
        agg = _aggregate(block, cfg, h, src, dst, dist, edge_mask, n_nodes)
    else:
        agg = None
        for a in range(0, e, edge_chunk):
            args = (block, cfg, h, src[a:a + edge_chunk],
                    dst[a:a + edge_chunk], dist[a:a + edge_chunk],
                    edge_mask[a:a + edge_chunk], n_nodes)
            part = (checkpoint(_aggregate, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _aggregate(*args))
            agg = part if agg is None else agg + part
    v = ssp(L.dense_apply(block["out1"], agg))
    return x + L.dense_apply(block["out2"], v)


def forward(params, cfg: SchNetConfig, batch: dict, *,
            edge_chunk: int = EDGE_CHUNK):
    """batch:
      nodes      - (N,) int32 atom types OR (N, d_feat) float features
      src, dst   - (E,) int32 edge endpoints
      dist       - (E,) float edge distances
      edge_mask  - (E,) 1.0 = real edge (padding support)
      graph_ids  - (N,) int32 graph membership (graph_reg only)
      n_graphs   - int (graph_reg only)
    Returns (n_graphs, n_out) for graph_reg, (N, n_out) for node_class.
    """
    if cfg.d_feat > 0:
        x = L.dense_apply(params["proj"], batch["nodes"].float())
    else:
        x = L.embedding_apply(params["embed"], batch["nodes"])
    n_nodes = x.shape[0]
    for block in params["blocks"]:
        x = interaction(block, cfg, x, batch["src"], batch["dst"],
                        batch["dist"], batch["edge_mask"], n_nodes,
                        edge_chunk=edge_chunk)
    h = ssp(L.dense_apply(params["head1"], x))
    out = L.dense_apply(params["head2"], h)  # (N, n_out)
    if cfg.task == "graph_reg":
        return torch.zeros((batch["n_graphs"], out.shape[1]),
                           dtype=out.dtype, device=out.device).index_add(
            0, batch["graph_ids"], out)
    return out


def loss_fn(params, cfg: SchNetConfig, batch: dict, *,
            edge_chunk: int = EDGE_CHUNK):
    out = forward(params, cfg, batch, edge_chunk=edge_chunk)
    if cfg.task == "graph_reg":
        return torch.mean(torch.square(out[..., 0] - batch["target"]))
    logits = out.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, batch["target"].long()[:, None])[:, 0]
    nll = (lse - picked) * batch["node_mask"]
    return nll.sum() / torch.clamp(batch["node_mask"].sum(), min=1.0)


def flops_per_edge(cfg: SchNetConfig) -> float:
    d, r = cfg.d_hidden, cfg.n_rbf
    filt = 2.0 * (r * d + d * d)
    return cfg.n_interactions * (filt + 3.0 * d)


def flops_per_node(cfg: SchNetConfig) -> float:
    d = cfg.d_hidden
    inp = 2.0 * (cfg.d_feat or 1) * d
    block = 3 * 2.0 * d * d
    head = 2.0 * (d * cfg.readout_hidden + cfg.readout_hidden * cfg.n_out)
    return inp + cfg.n_interactions * block + head
