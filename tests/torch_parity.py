"""Helpers of the zoo's parity tests: JAX trees to numpy, and gradients
held to ``jax.grad`` leaf by leaf."""
import jax
import numpy as np

from repro_torch.tree import leaves

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 5e-5  # of each gradient's largest magnitude


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def leaf_at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def assert_grads_close(jgrads, tgrads):
    """Every leaf of the port's gradient tree within GRAD_TOL of the JAX
    gradient's largest magnitude; the two trees have the same leaves."""
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    n = 0
    for path, want in flat:
        want = np.asarray(want)
        got = leaf_at(tgrads, path).detach().numpy()
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(leaves(tgrads))
