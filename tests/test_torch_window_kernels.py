"""The arithmetic of the serving window's two CUDA kernels, emulated on
the CPU.

``kernels/csrc/embedding_bag.cu`` sums a bag in a fixed order: with R
lanes to a row (the smallest power of two, at most 32, covering the
row's units of 4 floats, or of 1 float where the table is read a float
at a time) and P = 32 / R row slots, slot s sums the ids 32c + tP + s
(chunk c, step t < R) in that order as fmaf(w, row, acc), an id of
weight 0 adding nothing, and the slots' partials are added by a
__shfl_xor_sync tree.  ``kernels/csrc/cascade_truncate.cu`` scans a
request's row in chunks of 32 W slots, W = 4 adjacent slots a lane where
C % 4 == 0 (else 1): per-lane survivor counts, an inclusive warp scan
(__shfl_up_sync, or a ballot for W = 1), the survivors of earlier
chunks carried, kept clicks summed per lane, a stop at the chunk that
reaches ``expose`` survivors, and a __shfl_xor_sync tree at the end.

Here both are written in numpy and held against the JAX package's
Pallas kernels in interpret mode and the port's plain versions: the bag
at 1e-5 (f32 sums in another order), the truncation bit for bit (0/1
clicks, so every sum is an exact integer).  The emulation lives here
only; nothing on the main path uses it.  The kernels themselves are
held against the plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cascade_truncate import compact_truncate_revenue
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro_torch.kernels import ref

BAG_TOL = dict(rtol=1e-5, atol=1e-5)
INT_MAX = np.iinfo(np.int32).max


def lanes_to_a_row(d: int, vec: bool) -> int:
    """R, as the launcher picks it: units are 4 floats on a table read
    16 bytes at a time (base and row stride multiples of 16 bytes,
    D >= 4), else 1 float."""
    units = d // 4 if vec and d >= 4 else d
    r = 1
    while r < units and r < 32:
        r *= 2
    return r


def bag_emulated(table, ids, weights, r):
    """(B, D) bag sums in the kernel's order for R = r lanes to a row."""
    b, l = ids.shape
    p = 32 // r
    w = np.ones((b, l), np.float32) if weights is None else weights
    acc = np.zeros((b, p, table.shape[1]), np.float32)
    for c0 in range(0, l, 32):
        for t in range(r):
            idx = c0 + t * p + np.arange(p)
            on = idx < l
            idx = np.minimum(idx, l - 1)
            wt = np.where(on[None, :], w[:, idx], np.float32(0))  # (B, P)
            rows = table[ids[:, idx]]  # (B, P, D)
            rows = np.where((wt != 0)[..., None], rows, np.float32(0))
            # fmaf: the product is exact in f64, the sum rounds once
            # (to f64, then to f32; the double rounding is far inside
            # the gate)
            acc = (wt[..., None].astype(np.float64) * rows
                   + acc).astype(np.float32)
    off = 1
    while off < p:  # the xor tree over slots (lane offsets R, 2R, ...)
        acc = acc + acc[:, np.arange(p) ^ off]
        off *= 2
    return acc[:, 0]


def _bag_case(rng, v, d, b, l, weighted):
    """The table at the models' scale (0.02, as the window's table in
    chip_smoke.py).  At unit scale a 1,500-term f32 sum is beyond the
    1e-5 gate in any order: the Pallas kernel's own sum misses it
    against the plain version there
    (``test_unit_scale_long_bags_miss_the_gate_in_any_order``)."""
    table = (0.02 * rng.normal(size=(v, d))).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    w = None
    if weighted:
        w = rng.random((b, l)).astype(np.float32)
        w[:, l // 2:] = 0.0  # padded history adds nothing
    return table, ids, w


def _hold_bag(table, ids, w, r, *, table_t=None):
    got = bag_emulated(table, ids, w, r)
    wj = None if w is None else jnp.asarray(w)
    pallas = np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(ids), wj,
                                interpret=True))
    plain = ref.embedding_bag_ref(
        torch.from_numpy(table) if table_t is None else table_t,
        torch.from_numpy(ids), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got, pallas, **BAG_TOL)
    np.testing.assert_allclose(got, plain.numpy(), **BAG_TOL)


def test_bag_order_at_the_window_shape():
    """YDNN's mean history bag at the serving window's shape: V = 4000,
    D = 32 (R = 8, four rows to a warp instruction), B = 512, L = 100,
    history lengths uniform in [0, L] (about half of it masked, some
    bags empty), weights mask / max(count, 1)."""
    rng = np.random.default_rng(0)
    v, d, b, l = 4000, 32, 512, 100
    table = (0.02 * rng.normal(size=(v, d))).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = (np.arange(l)[None] < rng.integers(0, l + 1, (b, 1))) \
        .astype(np.float32)
    w = mask / np.maximum(mask.sum(-1, keepdims=True), 1.0)
    assert lanes_to_a_row(d, vec=True) == 8
    _hold_bag(table, ids, w, 8)


@pytest.mark.parametrize("d", [3, 4, 20, 64, 1030])
@pytest.mark.parametrize("l", [1, 1500])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_order_any_width_and_length(d, l, weighted):
    """D = 3 (a float at a time, R = 4), 4 (one unit, R = 1), 20 (5
    units, R = 8), 64 (16 units, R = 16), 1030 (a contiguous table with
    D % 4 != 0 is read a float at a time: R = 32 and 33 passes); one id,
    and 1,500 ids (47 chunks)."""
    rng = np.random.default_rng(d + l)
    b = 3 if d * l > 10_000 else 6
    table, ids, w = _bag_case(rng, 50, d, b, l, weighted)
    _hold_bag(table, ids, w, lanes_to_a_row(d, vec=d % 4 == 0))


def test_unit_scale_long_bags_miss_the_gate_in_any_order():
    """Why the long bags draw the table at 0.02: at unit scale, D = 1030
    and L = 1,500, the Pallas kernel's in-bag order and the plain
    version's differ beyond 1e-5, though both are right in f32."""
    rng = np.random.default_rng(1030 + 1500)
    table = rng.normal(size=(50, 1030)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 1500)).astype(np.int32)
    pallas = np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(ids),
                                interpret=True))
    plain = ref.embedding_bag_ref(torch.from_numpy(table),
                                  torch.from_numpy(ids)).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(pallas, plain, **BAG_TOL)


def test_bag_order_on_a_padded_view():
    """D = 30 in rows of stride 32: the aligned 28 columns go as 7 units
    of 4 (R = 8) and the last 2 a float at a time with the same R, so
    every column is summed in the same order."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(64, 32)).astype(np.float32)
    table = np.ascontiguousarray(base[:, :30])
    ids = rng.integers(0, 64, (5, 70)).astype(np.int32)
    w = rng.random((5, 70)).astype(np.float32)
    _hold_bag(table, ids, w, lanes_to_a_row(30, vec=True),
              table_t=torch.from_numpy(base)[:, :30])


def truncate_emulated(p, ck, groups, rows, n3, expose):
    """(B,) revenue@expose as the kernel scans it."""
    c = p.shape[2]
    w = 4 if c % 4 == 0 else 1
    lanes = np.arange(32)
    out = np.zeros(len(groups), np.float32)
    for b in range(len(groups)):
        prow, crow = p[groups[b], rows[b]], ck[groups[b], rows[b]]
        thr = n3[b]
        carry, done = 0, expose == 0
        acc = np.zeros(32, np.float32)
        c0 = 0
        while not done and c0 < c:
            s = c0 + lanes[:, None] * w + np.arange(w)[None]  # (32, W)
            on = s < c
            s = np.minimum(s, c - 1)
            pv = np.where(on, prow[s], INT_MAX)
            cv = np.where(on, crow[s], np.float32(0))
            m = pv < thr
            cnt = m.sum(axis=1)
            incl = cnt.copy()
            off = 1
            while off < 32:  # __shfl_up_sync scan (the ballot's sum)
                incl = incl + np.concatenate([np.zeros(off, int),
                                              incl[:-off]])
                off *= 2
            q = carry + incl - cnt
            for k in range(w):
                q = q + m[:, k]
                keep = m[:, k] & (q <= expose)
                acc = np.where(keep, acc + cv[:, k], acc)
            carry += int(incl[31])
            done = carry >= expose
            c0 += 32 * w
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[lanes ^ off]
        out[b] = acc[0]
    return out


def _truncation_tables(rng, c):
    """Rows whose survivor counts are uniform in [0, C] (row (0, 0) all
    sentinels), requests whose n3 is uniform in [0, C] (request 1's 0),
    request 0 on the sentinel row, 0/1 clicks."""
    g_n, u_n, b_n = 3, 6, 24
    p = np.empty((g_n, u_n, c), np.int32)
    for g in range(g_n):
        for u in range(u_n):
            count = 0 if g == u == 0 else rng.integers(0, c + 1)
            row = rng.permutation(c)
            p[g, u] = np.where(row < count, row, c)
    ck = (rng.random((g_n, u_n, c)) < 0.3).astype(np.float32)
    groups = rng.integers(0, g_n, b_n).astype(np.int32)
    rows = rng.integers(0, u_n, b_n).astype(np.int32)
    n3 = rng.integers(0, c + 1, b_n).astype(np.int32)
    groups[0] = rows[0] = 0
    n3[0], n3[1] = c, 0
    return p, ck, groups, rows, n3


@pytest.mark.parametrize("c", [1, 31, 32, 33, 200, 257, 260, 512])
@pytest.mark.parametrize("expose", [0, 1, 20, "C+5"])
def test_truncation_scan_is_exact(c, expose):
    """C = 1, 31, 33 (one slot a lane), 32, 200 (four), 257 (one slot a
    lane, past the 256 slots held in registers), 260 and 512 (four slots
    a lane past them); expose 0, 1, 20 and C + 5 (every survivor
    kept)."""
    expose = c + 5 if expose == "C+5" else expose
    rng = np.random.default_rng(c)
    args = _truncation_tables(rng, c)
    got = truncate_emulated(*args, expose)
    pallas = np.asarray(compact_truncate_revenue(
        *map(jnp.asarray, args), expose=expose, interpret=True))
    plain = ref.cascade_truncate_ref(*map(torch.from_numpy, args),
                                     expose=expose).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)
    assert got[0] == 0.0 and got[1] == 0.0  # sentinel row, n3 = 0
