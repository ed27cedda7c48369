"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300
cutoff=10, the JAX package's four train cells on one card.

Four graph regimes, all training steps (AdamW, no weight decay, lr 1e-3),
at the JAX cells' sizes, with edge counts padded to a multiple of 512
(padding edges carry ``edge_mask`` 0):

  full_graph_sm   2,708 nodes     10,752 edges  d_feat 1,433  7 classes
                  (Cora-sized, full batch)
  minibatch_lg    169,984 nodes  168,960 edges  d_feat 602   41 classes
                  (``budget_for(1024, (15, 10))``: 1,024 seeds sampled by
                  ``models/gnn/sampler.py`` from a seeded synthetic CSR
                  graph of Reddit's size, 232,965 nodes and about 11.6 M
                  edges, GraphSAGE arXiv:1706.02216; host work outside
                  the timed step)
  ogb_products    2,449,029 nodes  61,859,328 edges  d_feat 100  47
                  classes (ogbn-products-sized, full batch, drawn on the
                  device)
  molecule        3,840 nodes      8,192 edges  atom types  1 output
                  (128 molecules of 30 atoms and 64 edges, graph_reg)

Nothing is cut.  The JAX cell shards ogb_products' edges over the whole
mesh; here the model's edge chunks with recompute (``models/gnn/
schnet.py``) hold it on one card.  Distances are uniform in [0.5, 9.0].

``full_config(shape)`` takes the shape, unlike every other arch (the
task, d_feat and n_out are the graph's), and so does ``smoke_config``:
without one it is the JAX smoke config (graph_reg), with one the same
widths for that shape's task.  A cell runs at one of two presets
(``preset_of``): ``full_config(shape)`` (the default) on the JAX cell's
graph, or the smoke widths on a small graph of the shape's kind; any
other config raises, since the graph's size follows the preset.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.models.gnn import schnet as model
from repro_torch.models.gnn.sampler import (CSRGraph, budget_for,
                                            sample_subgraph)
from repro_torch.training.optimizer import AdamW
from repro_torch.training.trainer import (TrainState, init_state,
                                          value_and_grad)

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
SKIPPED_SHAPES: dict = {}

GRAPH_SHAPES = {
    # name: (n_nodes, n_edges, d_feat, n_out, task, n_graphs)
    "full_graph_sm": (2708, 10556, 1433, 7, "node_class", None),
    "ogb_products": (2_449_029, 61_859_140, 100, 47, "node_class", None),
    "molecule": (30 * 128, 64 * 128, 0, 1, "graph_reg", 128),
}
MINIBATCH = dict(seeds=1024, fanout=(15, 10), d_feat=602, n_out=41)
REDDIT = dict(n_nodes=232_965, n_edges=11_606_919)  # arXiv:1706.02216
EDGE_PAD = 512
DIST_RANGE = (0.5, 9.0)
LR = 1e-3
# the smoke widths' graphs: the JAX smoke batch (40 nodes, 80 edges, 4
# molecules); the sampler at 8 seeds, fanout (3, 2), on a 300-node graph
SMOKE_GRAPH = dict(n_nodes=40, n_edges=80, n_graphs=4, d_feat=12, n_out=5)
SMOKE_MINIBATCH = dict(seeds=8, fanout=(3, 2), n_nodes=300, n_edges=2400)


def _task_of(shape: str) -> tuple[int, int, str]:
    """(d_feat, n_out, task) of a shape's graph."""
    if shape == "minibatch_lg":
        return MINIBATCH["d_feat"], MINIBATCH["n_out"], "node_class"
    if shape not in GRAPH_SHAPES:
        raise KeyError(f"unknown shape {shape!r}; have {sorted(SHAPES)}")
    return GRAPH_SHAPES[shape][2:5]


def full_config(shape: str = "molecule") -> model.SchNetConfig:
    d_feat, n_out, task = _task_of(shape)
    return model.SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300,
                              cutoff=10.0, d_feat=d_feat, n_out=n_out,
                              task=task)


def smoke_config(shape: str | None = None) -> model.SchNetConfig:
    cfg = model.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=24,
                             cutoff=10.0, d_feat=0, n_out=1,
                             task="graph_reg")
    if shape is None or _task_of(shape)[2] == "graph_reg":
        return cfg
    return model.SchNetConfig(
        n_interactions=2, d_hidden=16, n_rbf=24, cutoff=10.0,
        d_feat=SMOKE_GRAPH["d_feat"], n_out=SMOKE_GRAPH["n_out"],
        task="node_class")


def preset_of(shape: str, cfg: model.SchNetConfig | None
              ) -> tuple[str, model.SchNetConfig]:
    """("full", ``full_config(shape)``) for None or the shape's full
    config; ("smoke", ``smoke_config(shape)``) for the smoke config,
    shape-less (as the cells CLI passes it to every shape) or the
    shape's own.  Any other config raises ValueError."""
    if cfg is None or cfg == full_config(shape):
        return "full", full_config(shape)
    if cfg in (smoke_config(), smoke_config(shape)):
        return "smoke", smoke_config(shape)
    raise ValueError(f"{shape}: a SchNet cell runs at full_config({shape!r})"
                     f" or the smoke widths, not {cfg}")


def cell_size(shape: str, cfg: model.SchNetConfig | None
              ) -> tuple[int, int]:
    """(n_nodes, n_edges) of a cell's graph, the edges padded to
    ``EDGE_PAD``: the JAX cell's at the full preset, the smoke graph's
    at the smoke preset (``preset_of``)."""
    full = preset_of(shape, cfg)[0] == "full"
    if shape == "minibatch_lg":
        mb = MINIBATCH if full else SMOKE_MINIBATCH
        n_nodes, n_edges = budget_for(mb["seeds"], mb["fanout"])
    elif full:
        n_nodes, n_edges = GRAPH_SHAPES[shape][:2]
    else:
        n_nodes, n_edges = SMOKE_GRAPH["n_nodes"], SMOKE_GRAPH["n_edges"]
    if full:
        n_edges = -(-n_edges // EDGE_PAD) * EDGE_PAD
    return n_nodes, n_edges


def _node_arrays(rng, cfg, n_nodes, device) -> dict:
    """Node inputs and targets of a node_class graph, drawn on the host."""
    return {"nodes": torch.from_numpy(rng.normal(
                size=(n_nodes, cfg.d_feat)).astype(np.float32)).to(device),
            "target": torch.from_numpy(rng.integers(
                0, cfg.n_out, n_nodes).astype(np.int32)).to(device),
            "node_mask": torch.ones(n_nodes, device=device)}


def _edges(rng, n_real, n_edges, src, dst, device) -> dict:
    """Edge arrays padded to ``n_edges``: the real ones first, then
    zero-distance padding edges 0 -> 0 with ``edge_mask`` 0."""
    pad = n_edges - n_real
    dist = rng.uniform(*DIST_RANGE, n_real).astype(np.float32)
    arrays = {"src": (src, np.zeros(pad, np.int32)),
              "dst": (dst, np.zeros(pad, np.int32)),
              "dist": (dist, np.zeros(pad, np.float32)),
              "edge_mask": (np.ones(n_real, np.float32),
                            np.zeros(pad, np.float32))}
    return {k: torch.from_numpy(np.concatenate(v)).to(device)
            for k, v in arrays.items()}


def synthetic_graph(rng: np.random.Generator, n_nodes: int,
                    n_edges: int) -> CSRGraph:
    """A seeded random graph's CSR: ``n_edges`` endpoints uniform over
    the nodes."""
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return CSRGraph.from_edges(src, dst, n_nodes)


def make_batch(shape: str, cfg: model.SchNetConfig, seed: int,
               device=None) -> dict:
    """The cell's graph at ``cfg``'s preset (``preset_of``), drawn from
    ``seed`` (on the device for ogb_products at full size)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    preset, cfg = preset_of(shape, cfg)
    full = preset == "full"
    n_nodes, n_edges = cell_size(shape, cfg)
    if shape == "minibatch_lg":
        mb = MINIBATCH if full else SMOKE_MINIBATCH
        graph = (synthetic_graph(rng, REDDIT["n_nodes"], REDDIT["n_edges"])
                 if full else synthetic_graph(rng, mb["n_nodes"],
                                              mb["n_edges"]))
        seeds = rng.choice(graph.n_nodes, mb["seeds"], replace=False)
        sub = sample_subgraph(graph, seeds, mb["fanout"], rng,
                              max_nodes=n_nodes, max_edges=n_edges)
        n_real = int(sub.edge_mask.sum())
        batch = _edges(rng, n_real, n_edges, sub.src[:n_real],
                       sub.dst[:n_real], device)
        batch.update(_node_arrays(rng, cfg, n_nodes, device))
        batch["node_mask"] = torch.from_numpy(sub.node_mask).to(device)
        return batch
    if cfg.task == "graph_reg":
        n_graphs = GRAPH_SHAPES["molecule"][5] if full \
            else SMOKE_GRAPH["n_graphs"]
        per, epg = n_nodes // n_graphs, n_edges // n_graphs
        # each molecule's edges join two of its own atoms
        base = np.repeat(np.arange(n_graphs) * per, epg).astype(np.int32)
        src = base + rng.integers(0, per, n_edges).astype(np.int32)
        dst = base + rng.integers(0, per, n_edges).astype(np.int32)
        batch = _edges(rng, n_edges, n_edges, src, dst, device)
        batch.update(
            nodes=torch.from_numpy(rng.integers(
                0, cfg.n_atom_types, n_nodes).astype(np.int32)).to(device),
            graph_ids=torch.from_numpy(np.repeat(
                np.arange(n_graphs), per).astype(np.int32)).to(device),
            n_graphs=n_graphs,
            target=torch.from_numpy(rng.normal(size=n_graphs).astype(
                np.float32)).to(device))
        return batch
    n_real = GRAPH_SHAPES[shape][1] if full else n_edges
    if shape == "ogb_products" and full:
        return _device_graph(seed, cfg, n_nodes, n_real, n_edges, device)
    src = rng.integers(0, n_nodes, n_real).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_real).astype(np.int32)
    batch = _edges(rng, n_real, n_edges, src, dst, device)
    batch.update(_node_arrays(rng, cfg, n_nodes, device))
    return batch


def _device_graph(seed: int, cfg, n_nodes: int, n_real: int, n_edges: int,
                  device) -> dict:
    """A node_class graph drawn on ``device`` from a generator there (the
    ogb_products graph: 61.9 M edges, 2.4 M x 100 features)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    mask = torch.zeros(n_edges, device=device)
    mask[:n_real] = 1.0
    src = torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **kw)
    dst = torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **kw)
    dist = torch.empty(n_edges, device=device).uniform_(*DIST_RANGE,
                                                        generator=g)
    src[n_real:], dst[n_real:], dist[n_real:] = 0, 0, 0.0
    return {"src": src, "dst": dst, "dist": dist, "edge_mask": mask,
            "nodes": torch.randn((n_nodes, cfg.d_feat), **kw),
            "target": torch.randint(0, cfg.n_out, (n_nodes,),
                                    dtype=torch.int32, **kw),
            "node_mask": torch.ones(n_nodes, device=device)}


def init_smoke(gen, cfg, device=None):
    return model.init(gen, cfg, device=device)


def smoke_batch(rng: np.random.Generator, cfg, device=None) -> dict:
    """The JAX smoke batch's arrays, drawn in its order."""
    n, e, g = 40, 80, 4
    dev = device or "cpu"

    def on(a):
        return torch.from_numpy(a).to(dev)

    return {
        "nodes": on(rng.integers(0, 10, n).astype(np.int32)),
        "src": on(rng.integers(0, n, e).astype(np.int32)),
        "dst": on(rng.integers(0, n, e).astype(np.int32)),
        "dist": on(rng.uniform(0.5, 9.0, e).astype(np.float32)),
        "edge_mask": torch.ones(e, device=dev),
        "graph_ids": on(np.repeat(np.arange(g), n // g).astype(np.int32)),
        "n_graphs": g,
        "target": on(rng.normal(size=g).astype(np.float32)),
    }


def smoke_loss(params, cfg, batch):
    return model.loss_fn(params, cfg, batch)


def make_cell(shape: str, cfg: model.SchNetConfig | None = None) -> Cell:
    """The JAX cell's train step on one card at ``cfg``'s preset
    (``preset_of``): ``fn(state, batch) -> (state, loss)``,
    ``make_args(seed, device)`` -> (a fresh ``TrainState``, the cell's
    graph)."""
    cfg = preset_of(shape, cfg)[1]
    n_nodes, n_edges = cell_size(shape, cfg)
    opt = AdamW(weight_decay=0.0)

    def step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(
            lambda p, b: model.loss_fn(p, cfg, b), state.params, batch)
        new_params, new_opt = opt.update(grads, state.opt_state,
                                         state.params, LR)
        return TrainState(state.step + 1, new_params, new_opt), loss

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        params = model.init(torch.Generator().manual_seed(seed), cfg,
                            device=device)
        return init_state(params, opt), make_batch(shape, cfg, seed, device)

    flops = (n_edges * model.flops_per_edge(cfg)
             + n_nodes * model.flops_per_node(cfg)) * 3.0  # fwd + bwd
    return Cell(arch_id=ARCH_ID, shape_name=shape, kind="train", fn=step,
                make_args=make_args,
                meta={"model_flops": flops, "n_edges": n_edges,
                      "n_nodes": n_nodes})
