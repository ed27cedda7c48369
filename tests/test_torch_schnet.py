"""SchNet and its neighbor sampler: the JAX package against the port, on
the CPU.

The same numpy inputs and the same weights (JAX's ``init`` carried over
by ``bridge.from_numpy_tree``) at the smoke widths, on both heads
(graph_reg on the JAX smoke batch of 4 molecules, node_class on a
40-node graph with padded edges):
* ``ssp``, ``rbf_expand`` and ``cosine_cutoff`` within 1e-5 (ssp also
  above softplus's threshold of 20, where ``F.softplus`` turns into the
  identity and ``jax.nn.softplus`` does not; the full-width RBF within
  1e-5 plus what a one-ulp shift of a linspace center can move it);
* ``forward`` and ``loss_fn`` within 1e-5, gradients within 5e-5 of
  each gradient's largest magnitude: unchunked, and chunked with
  recompute (``edge_chunk`` below the edge count), which is also held
  to the unchunked port within the same tolerances (the chunks sum the
  messages in another order);
* ``sample_subgraph`` returns the JAX sampler's arrays exactly from the
  same ``np.random.Generator`` state;
* the configs, FLOP counts and cell sizes mirror the JAX cells; each
  cell steps at smoke widths, and through the cells CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import schnet as jschnet_cfg
from repro.models.gnn import sampler as jsampler
from repro.models.gnn import schnet as jschnet
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs import schnet as schnet_cfg
from repro_torch.models.gnn import sampler, schnet
from repro_torch.training.trainer import value_and_grad
from torch_parity import F32_TOL, assert_grads_close, np_tree

# -- the pieces ---------------------------------------------------------------


def test_ssp_matches_jax_past_softplus_threshold():
    x = np.array([-90.0, -20.5, -3.0, 0.0, 1e-3, 4.0, 19.9, 20.1, 35.0,
                  90.0], np.float32)
    want = np.asarray(jschnet.ssp(jnp.asarray(x)))
    got = schnet.ssp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_rbf_and_cutoff_match_jax(preset):
    """At the smoke widths within 1e-5.  At the full widths (300 centers
    on [0, 10], gamma 895) torch's and XLA's linspace may place a center
    one ulp (9.5e-7 near 10) apart, and the Gaussian's slope, at most
    sqrt(2 gamma / e) = 25.7, turns that into up to 2.4e-5: there the
    centers are held to one ulp and the values to 1e-5 plus that."""
    cfg = getattr(schnet_cfg, f"{preset}_config")()
    jcfg = getattr(jschnet_cfg, f"{preset}_config")()
    d = np.random.default_rng(0).uniform(0.0, 12.0, 257).astype(np.float32)
    d[:3] = [0.0, 10.0, 9.999]
    got = schnet.rbf_expand(torch.from_numpy(d), cfg).numpy()
    want = np.asarray(jschnet.rbf_expand(jnp.asarray(d), jcfg))
    atol = 1e-5
    if preset == "full":
        mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf).numpy()
        jmu = np.asarray(jnp.linspace(0.0, jcfg.cutoff, jcfg.n_rbf))
        ulp = np.spacing(np.float32(cfg.cutoff))
        assert np.abs(mu - jmu).max() <= ulp
        gamma = 1.0 / float(mu[1] - mu[0]) ** 2
        atol += np.sqrt(2.0 * gamma / np.e) * ulp
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(
        schnet.cosine_cutoff(torch.from_numpy(d), cfg).numpy(),
        np.asarray(jschnet.cosine_cutoff(jnp.asarray(d), jcfg)), **F32_TOL)
    # the out-of-place form (a distance that needs a gradient) is the same
    t = torch.from_numpy(d).requires_grad_(True)
    torch.testing.assert_close(schnet.rbf_expand(t, cfg).detach(),
                               torch.from_numpy(got), rtol=0, atol=0)


# -- the model on bridged weights ---------------------------------------------


def _node_batch(rng, cfg, n=40, e=80, pad=16):
    """A node_class graph of ``n`` nodes, ``e`` edges of which the last
    ``pad`` are padding (edge_mask 0), and 3 masked-out nodes."""
    mask = np.ones(e, np.float32)
    mask[e - pad:] = 0.0
    node_mask = np.ones(n, np.float32)
    node_mask[-3:] = 0.0
    return {"nodes": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "dist": rng.uniform(0.5, 11.0, e).astype(np.float32),
            "edge_mask": mask,
            "target": rng.integers(0, cfg.n_out, n).astype(np.int32),
            "node_mask": node_mask}


def _smoke_batch(task):
    rng = np.random.default_rng(7)
    if task == "graph_reg":
        cfg = schnet_cfg.smoke_config()
        b = schnet_cfg.smoke_batch(rng, cfg)
        return {k: v if isinstance(v, int) else v.numpy()
                for k, v in b.items()}
    return _node_batch(rng, schnet_cfg.smoke_config("full_graph_sm"))


SHAPE_OF = {"graph_reg": "molecule", "node_class": "full_graph_sm"}


@pytest.fixture(scope="module", params=sorted(SHAPE_OF))
def pair(request):
    task = request.param
    cfg = schnet_cfg.smoke_config(SHAPE_OF[task])
    jcfg = jschnet.SchNetConfig(**dataclasses.asdict(cfg))
    assert cfg.task == task
    jp = jschnet.init(jax.random.PRNGKey(3), jcfg)
    like = schnet.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(np_tree(jp), like=like, device="cpu")
    return jcfg, cfg, jp, tp, _smoke_batch(task)


def _j(batch):
    return {k: v if isinstance(v, int) else jnp.asarray(v)
            for k, v in batch.items()}


def _t(batch):
    return {k: v if isinstance(v, int) else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("chunk", [schnet.EDGE_CHUNK, 16, 7])
def test_forward_matches_jax(pair, chunk):
    jcfg, cfg, jp, tp, batch = pair
    want = np.asarray(jschnet.forward(jp, jcfg, _j(batch)))
    got = schnet.forward(tp, cfg, _t(batch), edge_chunk=chunk)
    rows = batch["n_graphs"] if cfg.task == "graph_reg" else 40
    assert got.shape == (rows, cfg.n_out)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("chunk", [schnet.EDGE_CHUNK, 16, 7])
def test_loss_and_gradient_match_jax(pair, chunk):
    """Unchunked, and in chunks of 16 and 7 edges (80 edges: 5 and 12
    chunks, the last one short) with recompute."""
    jcfg, cfg, jp, tp, batch = pair
    jl, jg = jax.value_and_grad(
        lambda p: jschnet.loss_fn(p, jcfg, _j(batch)))(jp)
    tl, tg = value_and_grad(
        lambda p, b: schnet.loss_fn(p, cfg, b, edge_chunk=chunk), tp,
        _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    assert_grads_close(jg, tg)


def test_chunked_equals_unchunked(pair):
    """The chunked path against the unchunked one in the port itself:
    loss and every gradient."""
    _, cfg, _, tp, batch = pair
    whole = value_and_grad(lambda p, b: schnet.loss_fn(p, cfg, b), tp,
                           _t(batch))
    parts = value_and_grad(
        lambda p, b: schnet.loss_fn(p, cfg, b, edge_chunk=9), tp, _t(batch))
    torch.testing.assert_close(parts[0], whole[0], **F32_TOL)
    jgrads = jax.tree_util.tree_map(lambda t: t.numpy(), whole[1])
    assert_grads_close(jgrads, parts[1])
    with torch.no_grad():  # no checkpoint without autograd: same numbers
        torch.testing.assert_close(
            schnet.forward(tp, cfg, _t(batch), edge_chunk=9),
            schnet.forward(tp, cfg, _t(batch)), **F32_TOL)


# -- the sampler ------------------------------------------------------------


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


@pytest.mark.parametrize("seeds,fanout,n,e", [
    (8, (3, 2), 300, 2400),  # budgets bind nowhere
    (16, (5, 4), 120, 900),  # nodes revisited; the node budget binds
    (4, (15, 10), 60, 40),  # sparse: empty neighbor lists, frontier ends
])
def test_sampler_arrays_equal_jax(seeds, fanout, n, e):
    src, dst = _graph(seeds + n, n, e)
    jg = jsampler.CSRGraph.from_edges(src, dst, n)
    tg = sampler.CSRGraph.from_edges(src, dst, n)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges
    max_nodes, max_edges = sampler.budget_for(seeds, fanout)
    assert (max_nodes, max_edges) == jsampler.budget_for(seeds, fanout)
    if n == 120:
        max_nodes = 40
    s = np.random.default_rng(5).choice(n, seeds, replace=False)
    want = jsampler.sample_subgraph(jg, s, fanout, np.random.default_rng(9),
                                    max_nodes=max_nodes, max_edges=max_edges)
    got = sampler.sample_subgraph(tg, s, fanout, np.random.default_rng(9),
                                  max_nodes=max_nodes, max_edges=max_edges)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- configs, counts, the registry, cells and the CLI ------------------------


def test_configs_mirror_jax():
    for shape in schnet_cfg.SHAPES:
        assert dataclasses.asdict(schnet_cfg.full_config(shape)) == \
            dataclasses.asdict(jschnet_cfg.full_config(shape)), shape
    assert dataclasses.asdict(schnet_cfg.smoke_config()) == \
        dataclasses.asdict(jschnet_cfg.smoke_config())
    assert dataclasses.asdict(schnet_cfg.full_config()) == \
        dataclasses.asdict(jschnet_cfg.full_config())
    assert schnet_cfg.SHAPES == jschnet_cfg.SHAPES
    assert schnet_cfg.GRAPH_SHAPES == jschnet_cfg.GRAPH_SHAPES
    assert schnet_cfg.MINIBATCH == jschnet_cfg.MINIBATCH
    assert get_arch("schnet") is schnet_cfg


@pytest.mark.parametrize("shape", jschnet_cfg.SHAPES)
def test_cells_mirror_the_jax_cells(shape):
    """Sizes, padded edge counts and model_flops of the JAX cell, at the
    shape's own config (not molecule's)."""
    want = jschnet_cfg.make_cell(shape).meta
    cell = schnet_cfg.make_cell(shape)
    assert cell.kind == "train"
    assert {k: cell.meta[k] for k in want} == want
    cfg, jcfg = schnet_cfg.full_config(shape), jschnet_cfg.full_config(shape)
    assert schnet.flops_per_edge(cfg) == jschnet.flops_per_edge(jcfg)
    assert schnet.flops_per_node(cfg) == jschnet.flops_per_node(jcfg)


@pytest.mark.parametrize("shape", jschnet_cfg.SHAPES)
def test_cells_step_at_smoke_widths(shape):
    cfg = schnet_cfg.smoke_config(shape)
    cell = schnet_cfg.make_cell(shape, cfg=cfg)
    state, batch = cell.make_args(0, "cpu")
    n_nodes, n_edges = schnet_cfg.cell_size(shape, cfg)
    assert batch["src"].shape == batch["dist"].shape == (n_edges,)
    assert int(batch["src"].max()) < n_nodes
    assert int(batch["dst"].max()) < n_nodes
    losses = []
    for _ in range(3):
        state, loss = cell.fn(state, batch)
        losses.append(float(loss))
    assert int(state.step) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # the same seed gives the same graph
    again = cell.make_args(0, "cpu")[1]
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_minibatch_smoke_graph_is_the_sampler_subgraph():
    cfg = schnet_cfg.smoke_config("minibatch_lg")
    batch = schnet_cfg.make_batch("minibatch_lg", cfg, 3, "cpu")
    n_nodes, n_edges = sampler.budget_for(8, (3, 2))
    real = int(batch["edge_mask"].sum())
    assert 0 < real <= n_edges and batch["nodes"].shape[0] == n_nodes
    assert (batch["dist"][:real] >= 0.5).all()
    assert (batch["dist"][real:] == 0).all()
    assert float(batch["node_mask"].sum()) <= n_nodes


def test_molecule_edges_stay_inside_their_molecule():
    cfg = schnet_cfg.smoke_config()
    batch = schnet_cfg.make_batch("molecule", cfg, 1, "cpu")
    g = batch["graph_ids"]
    assert torch.equal(g[batch["src"].long()], g[batch["dst"].long()])
    assert batch["n_graphs"] == 4


def test_cell_runs_at_one_of_two_presets():
    """The graph's size follows the preset: the shape's full config (the
    default) or the smoke widths, shape-less as the cells CLI passes them
    or the shape's own; another config, such as another shape's full
    config or full widths with one field changed, raises."""
    full = schnet_cfg.make_cell("ogb_products")
    assert full.meta["n_edges"] == 61_859_328
    assert schnet_cfg.preset_of("ogb_products", None) == \
        ("full", schnet_cfg.full_config("ogb_products"))
    for cfg in (schnet_cfg.smoke_config(),
                schnet_cfg.smoke_config("ogb_products")):
        preset, got = schnet_cfg.preset_of("ogb_products", cfg)
        assert (preset, got) == ("smoke",
                                 schnet_cfg.smoke_config("ogb_products"))
        assert got.task == "node_class"
        cell = schnet_cfg.make_cell("ogb_products", cfg)
        assert (cell.meta["n_nodes"], cell.meta["n_edges"]) == (40, 80)
    for cfg in (schnet_cfg.full_config("molecule"),
                dataclasses.replace(schnet_cfg.full_config("ogb_products"),
                                    n_rbf=64)):
        with pytest.raises(ValueError, match="ogb_products"):
            schnet_cfg.make_cell("ogb_products", cfg)
        with pytest.raises(ValueError, match="ogb_products"):
            schnet_cfg.make_batch("ogb_products", cfg, 0, "cpu")


def test_cells_cli_runs_schnet_on_the_cpu(capsys):
    from repro_torch.launch import cells

    assert cells.main(["--arch", "schnet", "--shape", "full_graph_sm",
                       "--preset", "smoke", "--device", "cpu", "--calls",
                       "2"]) == 0
    out = capsys.readouterr().out
    assert "schnet x full_graph_sm" in out and out.count(" loss ") == 2
