"""Checkpoints cross between the packages, both ways, bit for bit.

A ``TrainState`` of DIN's smoke widths with AdamW moments (after two
steps, so the moments are not zeros) is written by one package and
restored by the other into a target of the same structure: every leaf
equal bit for bit, the manifests' keys, leaf names, shapes and dtypes
identical.  Plus the port's own atomic save, ``keep`` garbage collection,
bf16 leaves and a missing leaf.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din_arch as jdin_arch
from repro.models.recsys import din as jdin
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import din_arch
from repro_torch.models.recsys import din
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import TrainState, init_state
from repro_torch.tree import leaves_with_paths


def _jax_state():
    cfg = jdin_arch.smoke_config()
    o = jopt.AdamW(weight_decay=0.01)
    state = jtrainer.init_state(jdin.init(jax.random.PRNGKey(3), cfg), o)
    step = jtrainer.build_train_step(lambda p, b: jdin.loss_fn(p, cfg, b),
                                     o, jopt.constant_schedule(1e-2),
                                     donate=False)
    rng = np.random.default_rng(0)
    for _ in range(2):
        b = {k: jnp.asarray(v.numpy()) for k, v in
             din_arch.smoke_batch(rng, din_arch.smoke_config()).items()}
        state, _ = step(state, b)
    return state


def _port_target():
    """A zero-initialised port state of the same structure."""
    params = din.init(torch.Generator().manual_seed(9),
                      din_arch.smoke_config())
    return init_state(params, opt.AdamW())


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _jax_leaves(state):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]]


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    state = _jax_state()
    jck.save(str(tmp_path), 2, state)
    got, manifest = ck.restore(str(tmp_path), _port_target())
    assert isinstance(got, TrainState) and manifest["step"] == 2
    want = _jax_leaves(state)
    have = leaves_with_paths(got)
    assert [k for k, _ in have] == [k for k, _ in want]
    for (key, a), (_, b) in zip(have, want):
        assert a.dtype == torch.from_numpy(b.copy()).dtype, key
        np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
    assert int(got.step) == 2 and int(got.opt_state.step) == 2


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jstate = _jax_state()
    port = bridge.from_numpy_tree(
        {"p": jax.tree_util.tree_map(np.asarray, jstate.params),
         "mu": jax.tree_util.tree_map(np.asarray, jstate.opt_state.mu),
         "nu": jax.tree_util.tree_map(np.asarray, jstate.opt_state.nu)},
        device="cpu")
    state = TrainState(torch.tensor(2, dtype=torch.int32), port["p"],
                       opt.AdamState(torch.tensor(2, dtype=torch.int32),
                                     port["mu"], port["nu"]))
    ck.save(str(tmp_path / "port"), 2, state)
    jck.save(str(tmp_path / "jax"), 2, jstate)
    # the two packages write the same manifest
    assert _manifest(tmp_path / "port", 2) == _manifest(tmp_path / "jax", 2)
    target = jtrainer.init_state(jdin.init(jax.random.PRNGKey(5),
                                           jdin_arch.smoke_config()),
                                 jopt.AdamW())
    got, _ = jck.restore(str(tmp_path / "port"), target)
    for (key, a), (_, b) in zip(_jax_leaves(got), _jax_leaves(jstate)):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_bf16_leaves_are_written_as_jax_writes_them(tmp_path):
    """bf16 leaves: a JAX checkpoint restores in the port bit for bit,
    and the port writes the same 2-byte void array and manifest as JAX.
    (JAX's ``restore`` cannot cast a 2-byte void back, even from its own
    checkpoint, so the port-to-JAX direction is checked on the files.)"""
    bits = np.random.default_rng(1).integers(0, 2 ** 15, (4, 3)) \
        .astype(np.uint16)
    t = torch.from_numpy(bits).view(torch.bfloat16)
    jck.save(str(tmp_path / "jax"), 1, {"table": jnp.asarray(
        np.asarray(t.float()), jnp.bfloat16), "w": jnp.ones(2)})
    back, man = ck.restore(str(tmp_path / "jax"),
                           {"table": torch.zeros(4, 3, dtype=torch.bfloat16),
                            "w": torch.zeros(2)})
    assert torch.equal(back["table"].view(torch.int16),
                       t.view(torch.int16))
    assert [e["dtype"] for e in man["leaves"]] == ["bfloat16", "float32"]
    ck.save(str(tmp_path / "port"), 1, {"table": t, "w": torch.ones(2)})
    assert _manifest(tmp_path / "port", 1) == _manifest(tmp_path / "jax", 1)
    arrays = [np.load(os.path.join(tmp_path / d, "step_0000000001",
                                   "arrays.npz"))["leaf_00000"]
              for d in ("port", "jax")]
    assert arrays[0].dtype == arrays[1].dtype == np.dtype("V2")
    assert arrays[0].tobytes() == arrays[1].tobytes()


def test_atomic_save_keep_and_latest(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "step": torch.tensor(5, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, state, keep=2)
    assert ck.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    os.makedirs(tmp_path / ".step_0000000009.tmp.x")  # a save in flight
    assert ck.latest_step(str(tmp_path)) == 4
    restored, man = ck.restore(str(tmp_path), state, step=3)
    assert torch.equal(restored["w"], state["w"]) and man["step"] == 3
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(KeyError, match="missing leaf 'extra'"):
        ck.restore(str(tmp_path), {**state, "extra": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="queue A item 26"):
        ck.restore(str(tmp_path), state, mesh=object())
