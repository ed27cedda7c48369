"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device and skip without one (the skip
is decided inside the fixture, never at import).  Run them on a machine
with a card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as on the CPU: truncation exact, target attention 2e-5,
embedding bag 1e-5, dot interaction 2e-5 in f32 and 2e-2 in bf16 (the
bf16 output rounds once from an f32 sum taken in another order), CIN
1e-4 (f32 sums of up to 7,800 terms in another order), flash attention
2e-5 in f32 and 2e-2 in bf16 (the wgmma kernel).  CIN, target attention,
f32 flash attention and f32 dot interaction take their products as
3xTF32 on the tensor cores, whose arithmetic tests/test_torch_tf32x3.py
emulates on the CPU.  In bf16 both round P to bf16 before PV, the plain
version after normalising it and the kernel before (it divides by the
row sum at the end); the plain version also rounds the logits to bf16
out of its first einsum, which the kernel keeps in f32, and the kernel's
softcap takes the hardware tanh (relative error about 2^-11) and its
softmax the hardware exp2; the output rounds once in both.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


def _truncation_args(cuda, g_n, u_n, cap, b_n, n3_low=1):
    gen = _gen()
    perm = torch.argsort(torch.rand(g_n, u_n, cap, generator=gen), dim=-1)
    count = torch.randint(cap // 2, cap + 1, (g_n, u_n, 1), generator=gen)
    p = torch.where(perm < count, perm, torch.full_like(perm, cap)).int()
    ck = (torch.rand(g_n, u_n, cap, generator=gen) < 0.2).float()
    groups = torch.randint(0, g_n, (b_n,), generator=gen).int()
    rows = torch.randint(0, u_n, (b_n,), generator=gen).int()
    n3 = torch.randint(n3_low, cap + 1, (b_n,), generator=gen).int()
    return [x.to(cuda) for x in (p, ck, groups, rows, n3)]


@pytest.mark.parametrize("g_n,u_n,cap,b_n,expose", [
    (3, 5, 40, 32, 6), (16, 512, 200, 512, 20), (2, 3, 33, 9, 50),
    # C of one slot, one chunk less one, one, one more; C past the 256
    # slots held in registers, one slot a lane (257) and four (260, 512);
    # expose >= C; B odd (the last block's second warp idle)
    (2, 4, 1, 7, 1), (2, 4, 31, 7, 5), (2, 4, 32, 8, 40), (2, 4, 33, 9, 20),
    (4, 16, 257, 33, 20), (4, 16, 257, 33, 300), (4, 16, 260, 33, 20),
    (4, 16, 260, 33, 300), (4, 16, 512, 33, 20), (4, 16, 512, 33, 600)])
def test_cascade_truncate_kernel(cuda, g_n, u_n, cap, b_n, expose):
    args = _truncation_args(cuda, g_n, u_n, cap, b_n)
    before = ops.LAUNCHES["cascade_truncate"]
    got = ops.cascade_truncate(*args, expose=expose)
    assert ops.LAUNCHES["cascade_truncate"] == before + 1
    want = ref.cascade_truncate_ref(*args, expose=expose)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap", [33, 200, 257, 260, 512])
def test_cascade_truncate_kernel_empty_rows_and_zero_n3(cuda, cap):
    """Rows of sentinels only, n3 = 0 and expose = 0 give exactly 0."""
    p, ck, groups, rows, n3 = _truncation_args(cuda, 3, 8, cap, 65,
                                               n3_low=0)
    p[0, 0] = cap  # row (0, 0): sentinels only
    groups[:4] = 0
    rows[:4] = 0
    n3[4:8] = 0
    for expose in (0, 20):
        got = ops.cascade_truncate(p, ck, groups, rows, n3, expose=expose)
        want = ref.cascade_truncate_ref(p, ck, groups, rows, n3,
                                        expose=expose)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[:8].any()
        if expose == 0:
            assert not got.any()


@pytest.mark.parametrize("b,n,t,d,h1,h2,shared", [
    (3, 5, 7, 8, 12, 6, False), (4, 1, 100, 36, 80, 40, False),
    (64, 256, 100, 36, 80, 40, True), (2, 130, 9, 36, 80, 64, False)])
def test_target_attention_kernel(cuda, b, n, t, d, h1, h2, shared):
    gen = _gen()

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to(cuda)
    q = r(n, d, scale=0.3)[None].expand(b, n, d) if shared \
        else r(b, n, d, scale=0.3)
    keys = r(b, t, d, scale=0.3)
    mask = (torch.rand(b, t, generator=gen) > 0.3).float().to(cuda)
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws += [r(di, do, scale=di ** -0.5), r(do, scale=0.1)]
    got = ops.target_attention(q, keys, mask, *ws)
    want = ref.target_attention_ref(q, keys, mask, *ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,n,t,d,h1,h2,shared", [
    (3, 257, 100, 36, 80, 40, True),   # N past two blocks of 128
    (5, 33, 20, 36, 44, 40, False),    # h1 not a multiple of 16
    (2, 19, 12, 20, 100, 24, False)])  # over DIN's tiles: the wide ones
def test_target_attention_kernel_ragged_and_masked(cuda, b, n, t, d, h1, h2,
                                                   shared):
    """Ragged shapes, and user 0 with every step masked: its pooled keys
    are exactly 0."""
    gen = _gen()

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to(cuda)
    q = r(n, d, scale=0.3)[None].expand(b, n, d) if shared \
        else r(b, n, d, scale=0.3)
    keys = r(b, t, d, scale=0.3)
    mask = (torch.rand(b, t, generator=gen) > 0.3).float().to(cuda)
    mask[0] = 0.0
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws += [r(di, do, scale=di ** -0.5), r(do, scale=0.1)]
    before = ops.LAUNCHES["target_attention"]
    got = ops.target_attention(q, keys, mask, *ws)
    assert ops.LAUNCHES["target_attention"] == before + 1
    want = ref.target_attention_ref(q, keys, mask, *ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert not got[0].any()


@pytest.mark.parametrize("v,d,b,l", [
    (50, 20, 7, 9), (4000, 32, 512, 100), (100, 1000, 3, 5),
    # D a float at a time (1, 2, 3, 1030), in 4-float units (4, 8, 20,
    # 32, 64, 1000): every count of lanes to a row, 1 to 32, both ways;
    # one id, and 1,500 (47 chunks of 32); B not a multiple of the 4
    # bags a block
    (60, 1, 5, 100), (60, 2, 5, 100), (60, 4, 5, 100), (60, 8, 5, 100),
    (100, 64, 7, 100), (100, 64, 3, 1500),
    (60, 3, 5, 1), (60, 3, 6, 100), (60, 3, 3, 1500), (60, 20, 9, 1),
    (60, 20, 2, 1500), (60, 32, 7, 1), (4000, 32, 13, 1500),
    (100, 1000, 6, 1), (100, 1000, 5, 100), (100, 1000, 2, 1500),
    (100, 1030, 3, 1), (100, 1030, 3, 100), (100, 1030, 2, 1500)])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_kernel(cuda, v, d, b, l, weighted):
    gen = _gen()
    # at L = 1,500 the table is drawn at the models' scale (0.02): at
    # unit scale a 1,500-term f32 sum is beyond the gate in any order,
    # the Pallas kernel's own included (test_torch_window_kernels.py)
    scale = 0.02 if l > 100 else 1.0
    table = (scale * torch.randn(v, d, generator=gen)).to(cuda)
    ids = torch.randint(0, v, (b, l), generator=gen).to(cuda)
    w = None
    if weighted:
        w = torch.rand(b, l, generator=gen).to(cuda)
        w[:, l // 2:] = 0.0  # padded history is skipped
    before = ops.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(table, ids, w)
    assert ops.LAUNCHES["embedding_bag"] == before + 1
    want = ref.embedding_bag_ref(table, ids, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,offset,stride", [
    (32, 1, 32),    # base 4 bytes past 16-byte alignment: a float at a time
    (30, 0, 32),    # a padded view: 7 units of 4, then 2 floats
    (32, 4, 36),    # aligned base, row stride 36 floats (144 bytes)
    (32, 1, 36)])   # unaligned base, aligned stride
def test_embedding_bag_kernel_reads_views(cuda, d, offset, stride):
    """Tables that are views of a larger buffer: the kernel reads them
    through their base and row stride, 16 bytes at a time only where
    both are multiples of 16 bytes."""
    gen = _gen()
    v = 300
    buf = torch.randn(v * stride + offset + 4, generator=gen).to(cuda)
    table = buf[offset:offset + v * stride].view(v, stride)[:, :d]
    assert table.stride() == (stride, 1)
    ids = torch.randint(0, v, (9, 70), generator=gen).to(cuda)
    w = torch.rand(9, 70, generator=gen).to(cuda)
    got = ops.embedding_bag(table, ids, w)
    want = ref.embedding_bag_ref(table.contiguous(), ids, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_embedding_bag_kernel_zero_weights_and_repeats(cuda):
    """All-zero weights give exactly 0, an empty bag (L = 0) too, and two
    calls on the same inputs are bitwise equal (a fixed order)."""
    gen = _gen()
    table = torch.randn(4000, 32, generator=gen).to(cuda)
    ids = torch.randint(0, 4000, (513, 100), generator=gen).to(cuda)
    w = torch.rand(513, 100, generator=gen).to(cuda)
    w[::3] = 0.0
    got = ops.embedding_bag(table, ids, w)
    assert not got[::3].any()
    assert torch.equal(got, ops.embedding_bag(table, ids, w))
    empty = ops.embedding_bag(table, ids[:, :0], w[:, :0])
    torch.cuda.synchronize()
    assert empty.shape == (513, 32) and not empty.any()


def test_window_kernels_replay_in_a_cuda_graph(cuda):
    """Each wrapper captured in a CUDA graph: the replay writes what the
    eager call returns."""
    gen = _gen()
    targs = _truncation_args(cuda, 16, 512, 200, 512)
    table = (0.02 * torch.randn(4000, 32, generator=gen)).to(cuda)
    ids = torch.randint(0, 4000, (512, 100), generator=gen).int().to(cuda)
    w = torch.rand(512, 100, generator=gen).to(cuda)
    w[:, 50:] = 0.0
    calls = {"cascade_truncate":
             lambda: ops.cascade_truncate(*targs, expose=20),
             "embedding_bag": lambda: ops.embedding_bag(table, ids, w)}
    for name, call in calls.items():
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.LAUNCHES[name]
        with torch.cuda.graph(graph):
            out = call()
        assert ops.LAUNCHES[name] == before + 1  # the capture counts
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), name


@pytest.mark.parametrize("b,f,d", [(32, 27, 64), (7, 13, 32), (5, 27, 63),
                                   (512, 27, 64),
                                   # B = 1; a last block part filled;
                                   # DLRM-RM2's serve_bulk batch
                                   (1, 27, 64), (1001, 27, 64),
                                   (262_144, 27, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_dot_interact_kernel(cuda, b, f, d, dtype, tol):
    gen = _gen()
    feats = (0.3 * torch.randn(b, f, d, generator=gen)).to(dtype).to(cuda)
    before = ops.LAUNCHES["dot_interact"]
    got = ops.dot_interact(feats)
    assert ops.LAUNCHES["dot_interact"] == before + 1
    want = ref.dot_interact_ref(feats)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, f * (f - 1) // 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interact_kernel_is_bitwise_repeatable(cuda, dtype):
    feats = (0.3 * torch.randn(4099, 27, 64, generator=_gen())).to(dtype)
    feats = feats.to(cuda)
    first = ops.dot_interact(feats)
    second = ops.dot_interact(feats)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,hp,m,d,ho", [(8, 39, 39, 10, 200),
                                         (20, 200, 39, 10, 200),
                                         (5, 8, 12, 4, 16),
                                         (3, 7, 5, 1, 41)])
def test_cin_kernel(cuda, b, hp, m, d, ho):
    gen = _gen()
    w = (0.05 * torch.randn(ho, hp * m, generator=gen)).to(cuda)
    xp = torch.randn(b, hp, d, generator=gen).to(cuda)
    x0 = torch.randn(b, m, d, generator=gen).to(cuda)
    before = ops.LAUNCHES["cin_layer"]
    got = ops.cin_layer(w, xp, x0)
    assert ops.LAUNCHES["cin_layer"] == before + 1
    want = ref.cin_layer_ref(w, xp, x0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _cin_inputs(b, hp, m, d, ho, cuda):
    gen = _gen()
    k = hp * m
    w = ((2.0 / (ho + k)) ** 0.5 * torch.randn(ho, k, generator=gen))
    xp = torch.randn(b, hp, d, generator=gen)
    x0 = torch.randn(b, m, d, generator=gen)
    return w.to(cuda), xp.to(cuda), x0.to(cuda)


@pytest.mark.parametrize("b,hp,m,d,ho", [
    (512, 200, 39, 10, 200),  # serve_p99's layer 2: K cut into parts
    (512, 39, 39, 10, 200),   # and its layer 1 (K = 1,521, a ragged tail)
    (300, 39, 39, 1, 37),     # D = 1, H_out not a multiple of 8
    (9, 6, 3, 2, 9),          # m < 4: a k8 step spans several h
    (40, 5, 40, 3, 300)])     # H_out over three N tiles
def test_cin_kernel_split_k_and_ragged_shapes(cuda, b, hp, m, d, ho):
    args = _cin_inputs(b, hp, m, d, ho, cuda)
    before = ops.LAUNCHES["cin_layer"]
    got = ops.cin_layer(*args)
    assert ops.LAUNCHES["cin_layer"] == before + 1
    want = ref.cin_layer_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cin_kernel_stages_x_prev_in_chunks(cuda):
    """One row tile per SM leaves K whole (P = 1), so at Hp = 200 the
    consumers stage x_prev in two chunks of h."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    args = _cin_inputs(n_sm * 128 // 10, 200, 39, 10, 200, cuda)
    got = ops.cin_layer(*args)
    want = ref.cin_layer_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,hp", [(512, 200), (4096, 39)])
def test_cin_kernel_is_bitwise_repeatable(cuda, b, hp):
    """K's parts are added in a fixed order, without atomics: two runs
    give the same bits."""
    args = _cin_inputs(b, hp, 39, 10, 200, cuda)
    first = ops.cin_layer(*args)
    second = ops.cin_layer(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _flash_case(cuda, b, t, s, h, hk, d, dtype, tol, kw):
    gen = _gen()
    q, k, v = (torch.randn(*shape, generator=gen).to(dtype).to(cuda)
               for shape in ((b, t, h, d), (b, s, hk, d), (b, s, hk, d)))
    name = ops.flash_kernel(q, k, v)
    assert name == ("flash_attention_wgmma" if dtype == torch.bfloat16
                    else "flash_attention")
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    after = dict(ops.LAUNCHES)
    assert after == {**before, name: before[name] + 1}  # this kernel only
    want = ref.flash_attention_ref(q, k, v, scale=d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


FLASH_DTYPES = pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 2e-5), (torch.bfloat16, 2e-2)])


@pytest.mark.parametrize("b,t,s,h,hk,d", [
    (1, 128, 128, 2, 2, 64), (1, 200, 264, 4, 1, 32), (2, 64, 512, 8, 4, 128),
    (2, 100, 100, 8, 4, 256), (1, 77, 77, 4, 2, 16)])
@FLASH_DTYPES
@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=True, window=24, softcap=50.0),
    dict(causal=False), dict(causal=False, window=16, softcap=30.0)],
    ids=["causal", "window-softcap", "full", "noncausal-window"])
def test_flash_attention_kernel(cuda, b, t, s, h, hk, d, dtype, tol, kw):
    _flash_case(cuda, b, t, s, h, hk, d, dtype, tol, kw)


@pytest.mark.parametrize("b,t,s,h,hk,d,kw", [
    (1, 77, 77, 2, 1, 64, dict(causal=True)),  # T, S off every tile
    (2, 200, 264, 4, 2, 128, dict(causal=True, softcap=50.0)),
    (1, 130, 130, 8, 4, 256, dict(causal=True, window=65)),
    (1, 100, 300, 4, 4, 64, dict(causal=False)),  # T < S
    (1, 64, 520, 4, 2, 256, dict(causal=False, window=129, softcap=30.0)),
    (1, 300, 300, 4, 4, 256, dict(causal=True, window=65)),  # group 1
    (1, 300, 300, 8, 4, 128, dict(causal=True, window=129)),  # group 2
    (2, 260, 260, 8, 2, 64, dict(causal=True, window=129, softcap=50.0)),
], ids=["ragged-77", "ragged-200-264", "window65-130", "t-lt-s",
        "window129-cross", "window65-group1", "window129-group2",
        "window129-group4"])
@FLASH_DTYPES
def test_flash_attention_kernel_edges(cuda, b, t, s, h, hk, d, kw, dtype,
                                      tol):
    """Ragged T and S, T < S, windows that cross a tile edge, GQA groups
    1, 2 and 4."""
    _flash_case(cuda, b, t, s, h, hk, d, dtype, tol, kw)


@pytest.mark.parametrize("b,t,s,h,hk,d", [
    (1, 300, 300, 32, 2, 128),  # glm4-9b: a GQA group of 16
    (2, 200, 200, 16, 1, 128),  # group 16 on one kv head
    (1, 300, 300, 36, 36, 64),  # minicpm-2b: 36 heads, no grouping
    (2, 130, 130, 36, 36, 64),
], ids=["glm4-group16", "group16-hkv1", "minicpm-h36", "minicpm-h36-b2"])
@FLASH_DTYPES
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_kernel_dense_lm_heads(cuda, b, t, s, h, hk, d,
                                               dtype, tol, causal):
    """The head layouts of glm4-9b's and minicpm-2b's prefills: 32 query
    heads on 2 kv heads at dh = 128, and 36 heads at dh = 64 (a single
    64-wide chunk)."""
    _flash_case(cuda, b, t, s, h, hk, d, dtype, tol, dict(causal=causal))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_reads_strided_inputs(cuda, dtype, tol):
    """q, k and v as views of one fused projection (no copies)."""
    gen = _gen()
    qkv = torch.randn(2, 50, 16, 32, generator=gen).to(dtype).to(cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    name = ops.flash_kernel(q, k, v)
    before = ops.LAUNCHES[name]
    got = ops.flash_attention(q, k, v, window=20)
    assert ops.LAUNCHES[name] == before + 1
    want = ref.flash_attention_ref(q, k, v, window=20)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_f32_long_chain(cuda):
    """gemma2's global layer at T = S = 8,192 (dh = 256, softcap 50) in f32:
    every row sums up to 8,192 keys through tensor-core chains, so this
    is the case that shows the kernel's promotion intervals hold 2e-5."""
    _flash_case(cuda, 1, 8192, 8192, 8, 4, 256, torch.float32, 2e-5,
                dict(causal=True, softcap=50.0))


@pytest.mark.parametrize("d", [1, 13, 16, 77, 200])
def test_flash_attention_f32_any_head_width(cuda, d):
    """f32 takes any dh in [1, 256]: widths off the 8-column k step and off
    the 16-byte copy (4-byte copies with zero fill)."""
    _flash_case(cuda, 2, 150, 150, 4, 2, d, torch.float32, 2e-5,
                dict(causal=True, window=70, softcap=30.0))


def test_flash_attention_f32_reads_unaligned_strided_inputs(cuda):
    """Views whose strides and bases break the 16-byte copy: a fused
    projection of odd width, one element past an aligned base."""
    gen = _gen()
    flat = torch.randn(1 + 2 * 90 * 16 * 31, generator=gen).to(cuda)
    qkv = flat[1:].view(2, 90, 16, 31)
    q, k, v = qkv[..., :8, :30], qkv[..., 8:12, :30], qkv[..., 12:, :30]
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=33, softcap=50.0)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, window=33, softcap=50.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_wgmma_refuses_what_tma_cannot_read(cuda):
    """A bf16 call that breaks a TMA rule raises, forward and backward;
    it never runs the f32 kernels instead."""
    x = torch.randn(1, 8, 2, 72, device=cuda).to(torch.bfloat16)
    odd = x[..., :68]  # head stride 144 bytes, dh 68
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(odd, odd, odd)
    with pytest.raises(RuntimeError, match="multiple of 8"):
        ops.load().flash_attention_wgmma(odd, odd, odd, True, -1, 0.0, 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention_bwd(odd, odd, odd, odd, odd)
    with pytest.raises(RuntimeError, match="multiple of 8"):
        ops.load().flash_attention_bwd(odd, odd, odd, odd, odd, True, -1,
                                       0.0, 1.0)
    assert ops.LAUNCHES == before


def test_small_serve_card_matches_cpu(cuda):
    """The same small stack on the card and on the CPU."""
    from repro_torch.launch import serve

    runs = []
    for dev in ("cuda", "cpu"):
        stack = serve.build_stack(users=5000, requests=64, windows=2,
                                  small=True, device=dev)
        runs.append(serve.serve(stack))
    for a, b in zip(*(r.windows for r in runs)):
        assert (a.decisions_np == b.decisions_np).mean() >= 0.99
        torch.testing.assert_close(a.lam_after.cpu(), b.lam_after.cpu(),
                                   rtol=1e-2, atol=0.0)


def _small_stack(**kw):
    from repro_torch.launch import serve

    return serve.build_stack(users=5000, requests=64, windows=4,
                             small=True, device="cuda", **kw)


def test_window_graphs_bitwise_eager(cuda):
    """The captured window programs against the same programs run
    eagerly (``graphs=False``) at a pinned price, on cold and warm
    buckets: decisions, revenue, spend, downgrades, FLOPs and the
    published price bit for bit; and the scoring graphs' stage scores
    against eager ``score_slab`` on the batch they last scored."""
    from repro_torch.serving.pipeline import ServingPipeline

    stack = _small_stack()
    src, pipe = stack.source, stack.pipeline
    eager = ServingPipeline(src.universe, pipe.reward_params,
                            pipe.reward_cfg, stack.budget, graphs=False,
                            device=cuda)
    compiles = []
    for t, n in enumerate((48, 60, 50, 64, 64)):
        c = src.window(t, n)
        got, want = (p.serve_window(c.ctx, c.rows, tables=c.tables,
                                    lam=1e-9 * t, ready=c.ready)
                     for p in (pipe, eager))
        torch.cuda.synchronize()
        compiles.append(got.compiles)
        for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                     "lam_before", "lam_after"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (t, name)
    assert compiles == [2, 0, 0, 2, 0]  # (64, True) and (64, False)
    sp = src.programs[0]
    ref_scores = src.score_slab({k: v for k, v in sp.inputs.items()
                                 if k != "clicks"})
    torch.cuda.synchronize()
    for name, prog in sp.models.items():
        assert torch.equal(prog.out["scores"], ref_scores[name]), name


def test_window_replay_never_syncs(cuda):
    """A warm bucket's window under set_sync_debug_mode("error")."""
    stack = _small_stack()
    src, pipe = stack.source, stack.pipeline
    for t in range(3):
        c = src.window(t, 64)
        torch.cuda.synchronize()
        if t:  # the bucket is warm
            torch.cuda.set_sync_debug_mode("error")
        try:
            r = pipe.serve_window(c.ctx, c.rows, tables=c.tables,
                                  ready=c.ready)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert r.compiles == (0 if t else 2)


def test_stream_launch_counts_equal_eager(cuda):
    """Prefetched through the graphs, the kernels launch as eagerly: one
    truncation a window, one target attention an item block and one bag
    a scoring chunk, captures counting nothing."""
    from repro_torch.serving.stream import run_stream

    stack = _small_stack(chunk=64)
    src = stack.source
    sizes = [64, 150, 64, 150]
    ops.reset_launches()
    st = run_stream(stack.pipeline, sizes, src, prefetch=2)
    torch.cuda.synchronize()
    chunks = sum(-(-n // 64) for n in sizes)
    blocks = -(-src._n_items() // src.item_block)
    assert src.cache_misses == chunks and st.steady_compiles == 0
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "cascade_truncate": len(sizes), "target_attention": blocks * chunks,
        "embedding_bag": chunks}


def _multi_price_case(stack, mode):
    """A spec and a plan of (n, budget, cost_scale) windows, several on
    each bucket with other budgets and scales."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serving import spec as S

    b = stack.budget
    if mode == "tenants_priced":
        tb = serve.tenant_budgets(b, 2, 4.0)
        return (S.ConstraintSpec([S.TenantAxis(tuple(tb), priced=True)]),
                [(64, tb, 1.0), (64, 0.5 * tb, 2.0), (60, tb, 1.0),
                 (60, 1.5 * tb, 0.5), (64, tb, 1.0)])
    tb = serve.tenant_budgets(b, 3, 4.0)
    rg = 0.6 * b
    return (S.ConstraintSpec([S.TenantAxis(tuple(tb), priced=True),
                              S.RegionAxis(2, split="flow"),
                              S.GlobalAxis(pricing="carbon")]),
            [(96, np.array([*tb, rg, rg]), np.array([1.0, 1.0])),
             (96, np.array([*tb, rg, 0.5 * rg]), np.array([1.0, 2.0])),
             (90, np.array([*tb, 2 * rg, rg]), np.array([2.0, 1.0])),
             (90, np.array([*tb, rg, rg]), np.array([1.0, 1.0])),
             (96, np.array([*tb, rg, rg]), np.array([0.5, 1.0]))])


@pytest.mark.parametrize("mode", ["tenants_priced", "geotenants"])
def test_multi_price_graphs_bitwise_eager(cuda, mode):
    """The tenants-priced and geotenants window programs captured
    against the same programs run eagerly, at pinned (K,) prices, with
    the budgets and scales changing between windows of one bucket:
    every output bit for bit."""
    from repro_torch.serving.pipeline import ServingPipeline

    stack = _small_stack()
    src, base = stack.source, stack.pipeline
    spec, plan = _multi_price_case(stack, mode)
    pipes = [ServingPipeline.from_spec(src.universe, base.reward_params,
                                       base.reward_cfg, spec, graphs=g,
                                       device=cuda) for g in (True, False)]
    compiles = []
    for t, (n, bud, sc) in enumerate(plan):
        c = src.window(t, n)
        lam = pipes[1].lam.clone()  # the eager run's price, pinned
        got, want = (p.serve_window(c.ctx, c.rows, tables=c.tables,
                                    ready=c.ready, lam=lam, budget=bud,
                                    cost_scale=sc) for p in pipes)
        torch.cuda.synchronize()
        compiles.append(got.compiles)
        for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                     "lam_before", "lam_after", "tenant_spend", "regions",
                     "region_spend", "tr_spend"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            assert a is None or torch.equal(a, b), (mode, t, name)
    # three tenant blocks pad to multiples of lcm(32, 3): 90 and 96
    # requests share one padded bucket
    assert compiles == ([2, 0, 2, 0, 0] if mode == "tenants_priced"
                        else [2, 0, 0, 0, 0])


def test_multi_price_stream_zero_steady_captures(cuda):
    """A geotenants stream with per-window budget and scale traces
    through the graphs: each bucket captures once, on first sight."""
    import numpy as np

    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.stream import run_stream

    stack = _small_stack()
    src, base = stack.source, stack.pipeline
    spec, plan = _multi_price_case(stack, "geotenants")
    pipe = ServingPipeline.from_spec(src.universe, base.reward_params,
                                     base.reward_cfg, spec, device=cuda)
    st = run_stream(pipe, [n for n, _, _ in plan], src, prefetch=2,
                    budget_trace=[b for _, b, _ in plan],
                    scale_trace=[s for _, _, s in plan], forecast=True)
    torch.cuda.synchronize()
    assert st.compiles == [2, 0, 0, 0, 0] and st.steady_compiles == 0
    assert np.isfinite(st.total_spend) and st.total_revenue > 0


def test_cascade_server_serve_launches_truncation(cuda):
    """``CascadeServer.serve`` on the card runs the truncation kernel
    (one launch) and returns the CPU server's revenue exactly."""
    import numpy as np

    from repro_torch.cascade.engine import CascadeServer
    from repro_torch.core.action_chain import generate_action_chains
    from repro_torch.launch.serve import small_stage_specs

    rng = np.random.default_rng(0)
    u, i = 64, 300
    scores = {k: rng.normal(size=(u, i)).astype(np.float32)
              for k in ("DSSM", "YDNN", "DIN", "DIEN")}
    clicks = (rng.random((u, i)) < 0.15).astype(np.float32)
    chains = generate_action_chains(small_stage_specs(i, 8))
    card = CascadeServer(scores, chains, clicks, expose=8, device=cuda)
    host = CascadeServer(scores, chains, clicks, expose=8, device="cpu")
    rows = rng.integers(0, u, 200)
    dec = rng.integers(0, chains.n_chains, 200)
    before = ops.LAUNCHES["cascade_truncate"]
    rev, flops = card.serve(rows, dec)
    assert ops.LAUNCHES["cascade_truncate"] == before + 1
    np.testing.assert_array_equal(rev, host.serve(rows, dec)[0])
    np.testing.assert_array_equal(flops, chains.costs[dec])


def test_carbon_window_with_ledger_and_obs_graphs_bitwise_eager(cuda):
    """A carbon day's pipeline with a ``CarbonLedger`` and an ``Obs``
    attached: the captured windows equal ``graphs=False`` bit for bit on
    each window's gram budget and kappa * CI scale, each pipeline on its
    own nearline price; a warm window is served under
    set_sync_debug_mode("error"); both ledgers meter the same entries."""
    import dataclasses

    from repro_torch.carbon.controller import CarbonBudget
    from repro_torch.carbon.intensity import diurnal_trace
    from repro_torch.carbon.ledger import CarbonLedger
    from repro_torch.obs import Obs
    from repro_torch.serving.pipeline import ServingPipeline

    stack = _small_stack(scenario="carbon")
    src = stack.source
    cb = CarbonBudget.from_flops(stack.budget, diurnal_trace(),
                                 window_s=86400.0 / 4)
    sched = cb.schedule(4)
    pipes, obs = [], []
    for graphs in (True, False):
        obs.append(Obs())
        led = CarbonLedger(src.chains, cb.trace, window_s=cb.window_s,
                           obs=obs[-1])
        pipes.append(ServingPipeline(
            src.universe, stack.reward_params, stack.reward_cfg,
            cb.flops_ref, ledger=led, obs=obs[-1], graphs=graphs,
            device=cuda))
    compiles = []
    for t in range(4):
        c = src.window(t, 64)
        torch.cuda.synchronize()
        kw = dict(tables=c.tables, ready=c.ready,
                  budget=sched["grams"][t], cost_scale=sched["scale"][t])
        if t == 3:  # the bucket is warm
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = pipes[0].serve_window(c.ctx, c.rows, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = pipes[1].serve_window(c.ctx, c.rows, **kw)
        torch.cuda.synchronize()
        compiles.append(got.compiles)
        for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                     "lam_before", "lam_after"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (t, name)
    assert compiles == [2, 0, 0, 0]
    a, b = (p.ledger.entries for p in pipes)
    assert [dataclasses.asdict(e) for e in a] == [dataclasses.asdict(e)
                                                  for e in b]
    assert len(a) == 4 and {e[0] for e in obs[0].tracer.events} >= {
        "h2d", "dispatch", "dual_update", "ledger"}


# -- the backward kernels and training on the card ---------------------------

# backward against its plain version, relative to each gradient's largest
# magnitude: the weight gradients are f32 sums over every (b, n, t) pair
# in another order than the plain version's
BWD_TOL = 5e-5


def _attention_bwd_args(cuda, b, n, t, d, h1, h2):
    gen = _gen()

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to(cuda)
    mask = (torch.rand(b, t, generator=gen) > 0.3).float().to(cuda)
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws += [r(di, do, scale=di ** -0.5), r(do, scale=0.1)]
    return r(b, n, d), (r(b, n, d, scale=0.3), r(b, t, d, scale=0.3), mask,
                        *ws)


@pytest.mark.parametrize("b,n,t,d,h1,h2", [
    (3, 2, 7, 8, 12, 6), (48, 1, 10, 16, 16, 8), (5, 3, 40, 16, 16, 8),
    (300, 1, 100, 36, 80, 40), (2, 1, 33, 64, 128, 64), (4, 2, 1, 4, 3, 2),
    (3, 1, 0, 4, 3, 2)])
def test_target_attention_bwd_kernel(cuda, b, n, t, d, h1, h2):
    dout, args = _attention_bwd_args(cuda, b, n, t, d, h1, h2)
    ops.reset_launches()
    got = ops.target_attention_bwd(dout, *args)
    again = ops.target_attention_bwd(dout, *args)
    want = ref.target_attention_bwd_ref(dout, *args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["target_attention_bwd"] == 2
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
        if w.numel():  # dkeys is empty at T = 0 (dq and the rest are 0)
            scale = float(w.abs().max()) or 1.0
            assert float((g - w).abs().max()) <= BWD_TOL * scale


@pytest.mark.parametrize("v,d,b,l,weighted", [
    (7, 3, 4, 5, True), (4000, 32, 512, 100, True), (200, 8, 48, 10, True),
    (50, 300, 9, 70, True), (60, 1, 3, 1, False), (1000, 64, 200, 300,
                                                   False)])
def test_embedding_bag_bwd_kernel(cuda, v, d, b, l, weighted):
    gen = _gen()
    ids = torch.randint(0, v, (b, l), generator=gen)
    w = None
    if weighted:  # padded entries: weight 0 on id 0, as in the histories
        w = torch.rand(b, l, generator=gen) * (
            torch.rand(b, l, generator=gen) > 0.4)
        ids = torch.where(w > 0, ids, torch.zeros_like(ids)).to(cuda)
        w = w.to(cuda)
    ids = ids.to(cuda)
    dout = torch.randn(b, d, generator=gen).to(cuda)
    ops.reset_launches()
    got = ops.embedding_bag_bwd(dout, ids, w, v)
    assert torch.equal(got, ops.embedding_bag_bwd(dout, ids, w, v))
    assert ops.LAUNCHES["embedding_bag_bwd"] == 2
    torch.testing.assert_close(got, ref.embedding_bag_bwd_ref(dout, ids, w,
                                                              v),
                               rtol=1e-5, atol=1e-5)


def _check_attention_bwd(dout, args):
    got = ops.target_attention_bwd(dout, *args)
    again = ops.target_attention_bwd(dout, *args)
    want = ref.target_attention_bwd_ref(dout, *args)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
        assert torch.isfinite(g).all()
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= BWD_TOL * scale


@pytest.mark.parametrize("b,n,t,d,h1,h2,masked", [
    (37, 1, 100, 36, 80, 40, False),  # 3,700 pairs: the last round part-full
    (5, 1, 100, 36, 80, 40, False),  # B below the grid: a user a block
    (300, 1, 100, 36, 80, 40, True),  # users with every step masked
    (6, 2, 17, 36, 80, 40, False),  # N = 2: dkeys over rounds, in order n
    (4096, 1, 100, 36, 80, 40, False)])  # DIN's width, many rounds a block
def test_target_attention_bwd_kernel_tiling_edges(cuda, b, n, t, d, h1, h2,
                                                  masked):
    """The tiling's edges: pairs packed across users in rounds of 128,
    rounds that end inside a candidate, tiles with no unmasked pair (they
    add exactly 0 and are skipped) and a user's candidates in different
    rounds; the kernel within BWD_TOL of its plain version, bit for bit
    the same twice."""
    dout, args = _attention_bwd_args(cuda, b, n, t, d, h1, h2)
    if masked:
        mask = args[2]
        mask[:3] = 0.0  # three users in a row: whole tiles masked
        mask[10] = 0.0
        mask[11, :50] = 0.0
    _check_attention_bwd(dout, args)


def _bag_bwd_case(cuda, v, d, b, l, *, dtype, weighted, skew=0.0):
    """ids of ``dtype``; with ``skew``, that share of the positions on id 3
    and dyadic data (weights in quarters, dOut small integers), so every
    sum is exact in any order: a 46,000-term f32 sum of unit-scale terms
    is beyond 1e-5 in any order, and the check is then on the ordering."""
    gen = _gen()
    ids = torch.randint(0, v, (b, l), generator=gen)
    if skew:
        hot = torch.rand(b, l, generator=gen) < skew
        ids = torch.where(hot, torch.full_like(ids, 3), ids)
        w = torch.randint(0, 5, (b, l), generator=gen).float() / 4
        dout = torch.randint(-4, 5, (b, d), generator=gen).float()
    else:
        w = torch.rand(b, l, generator=gen) * (
            torch.rand(b, l, generator=gen) > 0.4)
        dout = torch.randn(b, d, generator=gen)
    if not weighted:
        w = None
    return dout.to(cuda), ids.to(dtype).to(cuda), (
        None if w is None else w.to(cuda)), v


@pytest.mark.parametrize("v,d,b,l,dtype,weighted,skew", [
    (4000, 32, 512, 100, torch.int32, True, 0.0),
    (4000, 32, 512, 100, torch.int64, True, 0.0),
    (4000, 32, 512, 100, torch.int32, True, 0.9),  # one id, 90 % of them
    (4000, 32, 512, 100, torch.int64, False, 0.9),
    (1_000_000, 32, 512, 100, torch.int64, True, 0.0),  # V >> ids
    (1_000_000, 32, 512, 100, torch.int32, False, 0.0),
    (200, 8, 48, 10, torch.int32, False, 0.0)])  # weights=None
def test_embedding_bag_bwd_kernel_ids_and_runs(cuda, v, d, b, l, dtype,
                                               weighted, skew):
    """int32 and int64 ids as they come, a skewed id holding 90 % of the
    positions (one long run), a million rows for 51,200 ids (most rows
    written as zero) and plain sums; within 1e-5 of the plain version,
    bit for bit the same twice, one launch counted a call."""
    dout, ids, w, v = _bag_bwd_case(cuda, v, d, b, l, dtype=dtype,
                                    weighted=weighted, skew=skew)
    ops.reset_launches()
    got = ops.embedding_bag_bwd(dout, ids, w, v)
    assert torch.equal(got, ops.embedding_bag_bwd(dout, ids, w, v))
    assert ops.LAUNCHES["embedding_bag_bwd"] == 2
    want = ref.embedding_bag_bwd_ref(dout, ids, w, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if skew:
        assert torch.equal(got, want)


def _grads_on(device, loss_fn, params, batch):
    from repro_torch.models import layers as L
    from repro_torch.training.trainer import value_and_grad

    return value_and_grad(loss_fn, L.to_device(params, device),
                          L.to_device(batch, device))


@pytest.mark.parametrize("model", ["DIN", "YDNN"])
def test_every_leaf_gets_its_gradient_on_the_card(cuda, model):
    """DIN's and YDNN's losses on the card (forward and backward kernels)
    against the CPU (plain versions) from the same weights and batch:
    the loss and every leaf's gradient within 1e-5, none left without
    one, the kernels' backward launched once."""
    import numpy as np

    from repro_torch import experiments as E
    from repro_torch.data.synthetic import WorldConfig, build_world, ctr_batch
    from repro_torch.models.recsys import din, ydnn
    from repro_torch.tree import leaves_with_paths

    world = build_world(WorldConfig(n_users=300, n_items=80, hist_len=10,
                                    seed=3))
    cfgs = dict(zip(("DSSM", "YDNN", "DIN", "DIEN"), E.stage_configs(world)))
    mod, loss = {"DIN": (din, din.loss_fn), "YDNN": (ydnn, E.ydnn_loss)}[model]
    params = mod.init(torch.Generator().manual_seed(0), cfgs[model])
    batch = ctr_batch(world, np.arange(300), np.random.default_rng(0), 64)
    batch.pop("users")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fn = E._bind_cfg(loss, cfgs[model])
    ops.reset_launches()
    l_card, g_card = _grads_on(cuda, fn, params, batch)
    kernel = {"DIN": "target_attention_bwd", "YDNN": "embedding_bag_bwd"}
    assert ops.LAUNCHES[kernel[model]] == 1
    l_cpu, g_cpu = _grads_on("cpu", fn, params, batch)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=1e-5)
    card = dict(leaves_with_paths(g_card))
    for path, g in leaves_with_paths(g_cpu):
        torch.testing.assert_close(card[path].cpu(), g, rtol=1e-5,
                                   atol=1e-5, msg=path)
        assert float(g.abs().max()) > 0 or path.startswith("out_emb"), path


def test_trained_stack_windows_graphs_bitwise_eager(cuda):
    """Stage and reward models trained on the card (a few steps each)
    serve through the CUDA graphs exactly as ``graphs=False``, and no
    backward kernel launches while serving: the autograd wrappers change
    nothing on the serving path."""
    import dataclasses

    from repro_torch import experiments as E
    from repro_torch.data.request_source import GeneratedSource
    from repro_torch.data.synthetic import StreamingWorld, WorldConfig
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.tree import leaves

    cfg = E.ExperimentConfig(
        world=WorldConfig(n_users=300, n_items=80, hist_len=10, seed=3),
        expose=4, n_scales=3, cascade_steps=4, reward_steps=4, batch=32)
    exp = E.build_experiment(cfg, device=cuda)
    params, rcfg = E.train_reward_model(exp)
    assert not any(p.requires_grad for p in leaves(exp.models.din_params))
    src = GeneratedSource(
        StreamingWorld.build(dataclasses.replace(cfg.world,
                                                 n_users=20_000)),
        exp.models, exp.chains, expose=cfg.expose, chunk=64, device=cuda)
    budget = 0.6 * float(exp.chains.costs.max()) * 64
    pipes = [ServingPipeline(src.universe, params, rcfg, budget,
                             graphs=g, device=cuda) for g in (True, False)]
    ops.reset_launches()
    for t in range(3):
        c = src.window(t, 64)
        got, want = (p.serve_window(c.ctx, c.rows, tables=c.tables,
                                    lam=1e-9 * t, ready=c.ready)
                     for p in pipes)
        torch.cuda.synchronize()
        for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                     "lam_before", "lam_after"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (t, name)
    assert ops.LAUNCHES["target_attention_bwd"] == 0
    assert ops.LAUNCHES["embedding_bag_bwd"] == 0


def test_kernels_without_backward_raise_on_cuda_inputs_needing_grads(cuda):
    """dot_interact has a backward kernel now (ROADMAP queue A item 25): a
    gradient through it on CUDA inputs launches the forward and the
    backward kernel once each and equals the plain backward; without a
    gradient only the forward launches."""
    x = torch.randn(4, 5, 8, device=cuda, requires_grad=True)
    ops.reset_launches()
    out = ops.dot_interact(x)
    g = torch.randn_like(out)
    out.backward(g)
    assert ops.LAUNCHES["dot_interact"] == 1
    assert ops.LAUNCHES["dot_interact_bwd"] == 1
    torch.testing.assert_close(x.grad, ref.dot_interact_bwd_ref(g, x.detach()),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert ops.dot_interact(x).shape == (4, 10)
    assert ops.LAUNCHES["dot_interact_bwd"] == 1


def _random_server(device, u_n=300, i_n=150, seed=0):
    """A materialized ``CascadeServer`` over random stage scores and
    clicks, on the small paper-shaped chain space, and a random reward
    model: what the replay tests serve."""
    import numpy as np

    from repro_torch.cascade.engine import CascadeServer
    from repro_torch.core.reward_model import (RewardModelConfig,
                                               reward_model_init)
    from repro_torch.launch import serve

    rng = np.random.default_rng(seed)
    scores = {k: rng.normal(size=(u_n, i_n)).astype(np.float32)
              for k in ("DSSM", "YDNN", "DIN", "DIEN")}
    clicks = (rng.random((u_n, i_n)) < 0.15).astype(np.float32)
    chains = serve.generate_action_chains(serve.small_stage_specs(i_n, 8))
    server = CascadeServer(scores, chains, clicks, expose=8, device=device)
    rcfg = RewardModelConfig(n_stages=3, max_models=2, n_scale_groups=4,
                             d_context=12, d_feature=16, d_hidden=16,
                             d_state=8)
    params = reward_model_init(torch.Generator().manual_seed(seed), rcfg,
                               device)
    ctx = rng.normal(size=(u_n, 12)).astype(np.float32)
    return server, ctx, params, rcfg


def test_replay_device_tables_equal_memmapped(cuda, tmp_path):
    """The replay with its universe on the card (each window an
    ``index_select`` there) against its memmapped reload (host tables,
    copied each window), served through the window graphs over a spike:
    decisions, revenue, spends, downgrades and prices bit for bit; the
    window's tables equal too, and the device form copies only the
    arrivals after its first window."""
    from repro_torch.data.request_source import TableReplaySource
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.stream import run_stream

    server, ctx, params, rcfg = _random_server(cuda)
    dev_src = TableReplaySource.from_server(server, ctx, seed=3)
    dev_src.save(str(tmp_path / "u"))
    disk = TableReplaySource.load(str(tmp_path / "u"), server.chains, seed=3,
                                  device=cuda)
    assert dev_src.device_tables and not disk.device_tables
    a, b = dev_src.window(9, 77), disk.window(9, 77)
    assert a.tables["p"].is_cuda and not isinstance(b.tables["p"],
                                                    torch.Tensor)
    torch.cuda.synchronize()
    for k in ("p", "ck"):
        assert torch.equal(a.tables[k].cpu(), torch.from_numpy(b.tables[k]))
    assert dev_src.window(10, 33).h2d_bytes == 33 * 4
    sizes = [64, 64, 192, 192, 64]
    budget = 0.5 * float(server.chains.costs.max()) * 64
    runs = [run_stream(ServingPipeline(src.universe, params, rcfg, budget),
                       sizes, src, prefetch=2, sync=torch.cuda.synchronize)
            for src in (dev_src, disk)]
    for t, (x, y) in enumerate(zip(*(r.windows for r in runs))):
        for f in ("decisions", "revenue", "spend", "downgraded", "lam_after"):
            assert torch.equal(getattr(x, f), getattr(y, f)), (t, f)
    assert runs[0].total_revenue > 0 and runs[0].steady_compiles == 0


def test_rank_serve_kernel_matches_plain(cuda):
    """greenflow-cascade's ``rank_serve`` at DIN's full widths (embed 18,
    T = 100, attention 80-40) and its 200 candidates a request (two
    blocks of 128, the second partly empty): the ``target_attention``
    kernel against its plain version within 2e-5, and the cell's scores
    against the same scores through the plain version."""
    import numpy as np

    from repro_torch.configs import greenflow_cascade as gfc
    from repro_torch.models.recsys import din

    dcfg = din.DINConfig(item_vocab=5000, cat_vocab=300, user_vocab=2000)
    rng = np.random.default_rng(1)
    b, n = 24, gfc.FULL_SIZES["rank_cands"]
    params = din.init(torch.Generator().manual_seed(1), dcfg, device=cuda)
    user = {k: torch.as_tensor(v, device=cuda) for k, v in
            gfc.din_arch._user(rng, dcfg, b).items()}
    user["hist_mask"][:, 70:] = 0.0  # ragged histories
    cid = torch.as_tensor(rng.integers(0, dcfg.item_vocab, (b, n)),
                          device=cuda)
    ccat = torch.as_tensor(rng.integers(0, dcfg.cat_vocab, (b, n)),
                           device=cuda)
    keys = din.embed_items(params, user["hist_ids"], user["hist_cats"])
    q = din.embed_candidates(params, cid, ccat)
    ws = din._attn_weights(params)
    before = ops.LAUNCHES["target_attention"]
    got = ops.target_attention(q, keys, user["hist_mask"], *ws)
    assert ops.LAUNCHES["target_attention"] == before + 1
    want = ref.target_attention_ref(q, keys, user["hist_mask"], *ws)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        scores = din.score(params, dcfg, user, cid, ccat)
    assert scores.shape == (b, n) and torch.isfinite(scores).all()


@pytest.mark.parametrize("mode", ["plain", "geotenants"])
def test_unguarded_window_graphs_bitwise_eager(cuda, mode):
    """``guard=False``: each bucket's window program captured (its own
    graphs) against the same program run eagerly, at a pinned price, on
    cold and warm buckets: decisions, revenue, spend and price bit for
    bit, nothing downgraded."""
    import numpy as np

    from repro_torch.data.request_source import TableReplaySource
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.spec import (ConstraintSpec, GlobalAxis,
                                          RegionAxis, TenantAxis)

    server, ctx, params, rcfg = _random_server(cuda)
    src = TableReplaySource.from_server(server, ctx, seed=5)
    c_max = float(server.chains.costs.max())
    if mode == "plain":
        axes, kw = [GlobalAxis(budget=0.2 * c_max * 64)], {}
        lam = 1e-9
    else:
        axes = [TenantAxis((0.1 * c_max * 32,) * 2, priced=True),
                RegionAxis(2), GlobalAxis(pricing="carbon")]
        kw = dict(budget=np.full(4, 0.1 * c_max * 64, np.float32),
                  cost_scale=np.array([1.0, 1.4], np.float32))
        lam = np.full(4, 1e-9, np.float32)
    pipes = [ServingPipeline.from_spec(src.universe, params, rcfg,
                                       ConstraintSpec(axes), guard=False,
                                       graphs=g, device=cuda)
             for g in (True, False)]
    compiles = []
    for t, n in enumerate((64, 64, 128, 64)):
        c = src.window(t, n)
        got, want = (p.serve_window(c.ctx, c.rows, tables=c.tables,
                                    ready=c.ready, lam=lam, **kw)
                     for p in pipes)
        torch.cuda.synchronize()
        compiles.append(got.compiles)
        assert int(got.downgraded) == 0
        for name in ("decisions", "revenue", "spend", "flops", "lam_after"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (t, name)
    assert compiles == [2, 0, 2, 0]


@pytest.mark.parametrize("job", ["plain", "geotenants"])
def test_two_processes_on_the_card_equal_one(cuda, tmp_path, job):
    """Two processes on the card (a gloo group through the host) serve
    the cheap replay stack at S = 8 as one process does, bit for bit:
    every host's prices and spends, the stitched decisions and regions,
    zero steady-state captures."""
    import torch_mh_child as child

    ref = child.finish(child.start(1, job, tmp_path, "ref", device="cuda"))
    two = child.finish(child.start(2, job, tmp_path, "two", device="cuda"))
    child.assert_group_matches(ref[0], two, job)
    for h in [*ref, *two]:
        assert h["host"]["platform"] == "gpu"
        assert h["jobs"][job]["steady_compiles"] == 0


# -- the backward kernels of dot interaction, CIN and flash attention --------

BWD_REL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _close_rel(got, want):
    """Each gradient within BWD_REL of its largest magnitude, same dtype."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        scale = float(w.double().abs().max()) or 1.0
        err = float((g.double() - w.double()).abs().max())
        assert err <= BWD_REL[w.dtype] * scale, (err, scale)


def _launched_once(name, fn):
    ops.reset_launches()
    out = fn()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {name: 1}
    return out


def _bwd_case(b, f, d, offset=0):
    """A case of ``test_dot_interact_bwd_kernel``: b None stands for each
    batch one sample past a whole grid of warps (4 to 16 warps an SM);
    ``offset`` views feats one element into a flat buffer."""
    name = "grid-warps+1" if b is None else str(b)
    return pytest.param(b, f, d, offset,
                        id=f"{name}-{f}-{d}" + ("-unaligned" if offset
                                                else ""))


@pytest.mark.parametrize("b,f,d,offset", [
    _bwd_case(7, 13, 32), _bwd_case(5, 27, 63), _bwd_case(3, 1, 4),
    _bwd_case(4, 2, 8), _bwd_case(1000, 27, 64),
    # the warp-pipelined kernel's edges: one sample; the grid's warps
    # taking one sample more than a whole round; strips of 16 rows and one
    # pass of 32 (F = 33 writes straight to device memory); n8 tiles and
    # 32-byte column steps; rows that are not 16-byte multiples; a base
    # that is not 16-byte aligned (plain loads)
    _bwd_case(1, 27, 64), _bwd_case(None, 27, 64),
    _bwd_case(50, 16, 64), _bwd_case(50, 17, 64), _bwd_case(50, 32, 64),
    _bwd_case(50, 33, 64), _bwd_case(50, 27, 8), _bwd_case(50, 27, 56),
    _bwd_case(50, 27, 72), _bwd_case(50, 27, 128), _bwd_case(300, 27, 63),
    _bwd_case(9, 27, 64, 1), _bwd_case(5, 27, 63, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interact_bwd_kernel(cuda, b, f, d, offset, dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bsz in [b] if b is not None else [sms * w + 1 for w in (4, 8, 12,
                                                                16)]:
        gen = torch.Generator(device=cuda).manual_seed(bsz + f)
        flat = 0.3 * torch.randn(offset + bsz * f * d, generator=gen,
                                 device=cuda)
        x = flat.to(dtype)[offset:].view(bsz, f, d)
        assert x.data_ptr() % 16 == (2 * offset if dtype == torch.bfloat16
                                     else 4 * offset)
        g = torch.randn(bsz, f * (f - 1) // 2, generator=gen,
                        device=cuda).to(dtype)
        got = _launched_once("dot_interact_bwd",
                             lambda: ops.dot_interact_bwd(g, x))
        _close_rel((got,), (ref.dot_interact_bwd_ref(g, x),))
        assert torch.equal(got, ops.dot_interact_bwd(g, x))


@pytest.mark.parametrize("b,hp,m,d,ho,x0_is", [
    (5, 8, 12, 4, 16, "own"), (3, 7, 5, 1, 41, "own"),
    (8, 39, 39, 10, 200, "own"), (13, 3, 64, 5, 7, "own"),
    (4096, 39, 39, 10, 200, "own"), (700, 200, 39, 10, 200, "own"),
    # x_prev is x0 (xDeepFM's first layer)
    (4096, 39, 39, 10, 200, "x_prev"),
    # x0 is x_prev's leading m rows: at B = 1 both are contiguous and
    # start at one address, yet x_prev holds more rows
    (1, 50, 39, 10, 200, "head"),
    # dx channel tiles of three h of m = 39 padded to 40 (Hp = 17: the
    # last tile holds two), of one h of m = 64, of m = 40 unpadded and of
    # m = 33 padded to 40; 257 columns (a block of one); D = 1
    (257, 17, 39, 1, 200, "own"), (700, 41, 39, 1, 200, "own"),
    (129, 3, 40, 2, 256, "own"), (300, 5, 33, 3, 97, "own"),
    # the columns cut into three parts (B = 4,096, D = 3) at m = 64
    (4096, 5, 64, 3, 100, "own"),
])
def test_cin_layer_bwd_kernel(cuda, b, hp, m, d, ho, x0_is):
    """Ragged column blocks, the dx kernel's channel tiles at their edges
    (m padded to a multiple of 8, a last tile short of h), D = 1, H_out
    up to 256, x_prev given as x0 or x0 as x_prev's head, and B = 4,096
    and 700 (the columns cut into parts summed in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(hp + ho)
    k = hp * m
    x_prev = torch.randn(b, hp, d, generator=gen, device=cuda)
    x0 = {"own": lambda: torch.randn(b, m, d, generator=gen, device=cuda),
          "x_prev": lambda: x_prev, "head": lambda: x_prev[:, :m]}[x0_is]()
    args = (torch.randn(b, ho, d, generator=gen, device=cuda),
            (2.0 / (ho + k)) ** 0.5 * torch.randn(ho, k, generator=gen,
                                                  device=cuda),
            x_prev, x0)
    got = _launched_once("cin_layer_bwd", lambda: ops.cin_layer_bwd(*args))
    _close_rel(got, ref.cin_layer_bwd_ref(*args))
    assert all(torch.equal(a, b_) for a, b_ in
               zip(got, ops.cin_layer_bwd(*args)))


@pytest.mark.parametrize("shape,kw", [
    ((1, 32, 32, 2, 2, 64), {}),
    ((2, 77, 77, 4, 2, 16), dict(window=16)),
    ((1, 100, 130, 4, 1, 128), dict(softcap=50.0, scale=0.3)),
    ((2, 64, 96, 8, 4, 256), dict(window=40, softcap=30.0)),
    ((1, 45, 45, 3, 3, 104), dict(causal=False)),
    ((2, 150, 150, 4, 2, 64), dict(causal=False, window=33, softcap=50.0)),
    ((1, 300, 300, 8, 4, 256), dict(window=100, softcap=50.0,
                                    scale=1 / 16)),
    # the bf16 kernels' tiles (64 keys and 64 queries a kv step, 128
    # queries and 32 keys a q step): T and S off them, a window edge
    # inside a tile, dh 8 to 256, groups of 1, 2, 16 and 36 heads of 1,
    # and glm4-9b's group of 16 heads at dh 128
    ((1, 200, 200, 16, 1, 8), {}),
    ((2, 300, 300, 32, 2, 128), {}),
    ((1, 130, 190, 2, 2, 64), dict(window=70)),
    ((1, 160, 160, 36, 36, 64), dict(softcap=50.0)),
    ((2, 97, 97, 4, 2, 128), dict(causal=False, window=50)),
    ((1, 257, 257, 4, 2, 256), dict(window=129, softcap=50.0,
                                    scale=1 / 16)),
    ((4, 2112, 2112, 4, 2, 64), dict(window=300)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(cuda, shape, kw, dtype):
    b, t, s, h, hk, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(t + dh)
    q, k, v = (torch.randn(*sh, generator=gen, device=cuda).to(dtype)
               for sh in ((b, t, h, dh), (b, s, hk, dh), (b, s, hk, dh)))
    out = ops.flash_attention(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    got = _launched_once("flash_attention_bwd",
                         lambda: ops.flash_attention_bwd(g, q, k, v, out,
                                                         **kw))
    _close_rel(got, ref.flash_attention_bwd_ref(g, q, k, v, out, **kw))
    assert all(torch.equal(a, b_) for a, b_ in
               zip(got, ops.flash_attention_bwd(g, q, k, v, out, **kw)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_launches_the_backward_kernels(cuda, dtype):
    """A gradient through cin_layer (f32) and flash attention on CUDA
    inputs launches each forward and backward kernel once and equals the
    plain backward; under no_grad only the forwards launch."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 40, h, 64, generator=gen, device=cuda)
               .to(dtype).requires_grad_(True) for h in (4, 2, 2))
    fwd = "flash_attention_wgmma" if dtype == torch.bfloat16 \
        else "flash_attention"
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, window=16, softcap=50.0)
    g = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    out.backward(g)
    assert {k_: n for k_, n in ops.LAUNCHES.items() if n} == {
        fwd: 1, "flash_attention_bwd": 1}
    want = ref.flash_attention_bwd_ref(g, q.detach(), k.detach(), v.detach(),
                                       out.detach(), window=16, softcap=50.0)
    _close_rel((q.grad, k.grad, v.grad), want)
    w = torch.randn(16, 6 * 5, generator=gen, device=cuda, requires_grad=True)
    x0 = torch.randn(9, 5, 3, generator=gen, device=cuda, requires_grad=True)
    xp = torch.randn(9, 6, 3, generator=gen, device=cuda, requires_grad=True)
    ops.reset_launches()
    y = ops.cin_layer(w, xp, x0)
    dy = torch.randn(y.shape, generator=gen, device=cuda)
    y.backward(dy)
    assert {k_: n for k_, n in ops.LAUNCHES.items() if n} == {
        "cin_layer": 1, "cin_layer_bwd": 1}
    _close_rel((w.grad, xp.grad, x0.grad),
               ref.cin_layer_bwd_ref(dy, w.detach(), xp.detach(),
                                     x0.detach()))
    ops.reset_launches()
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.cin_layer(w, xp, x0)
    assert {k_: n for k_, n in ops.LAUNCHES.items() if n} == {
        fwd: 1, "cin_layer": 1}


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm", "gemma2-2b",
                                  "glm4-9b", "minicpm-2b",
                                  "granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_smoke_train_step_card_vs_cpu(cuda, arch):
    """Each arch's smoke-width train cell from one init, on the card and
    on the CPU: the loss within 1e-5 and every gradient within BWD_REL of
    its largest magnitude (the LMs' smoke widths run the f32 flash
    kernels; the recsys tables are bf16)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.training.trainer import micro_value_and_grad
    from repro_torch.tree import leaves

    mod = get_arch(arch)
    cfg = mod.smoke_config()
    shape = "train_batch" if mod.FAMILY == "recsys" else "train_4k"
    cell = mod.make_cell(shape, cfg)
    state, batch = cell.make_args(0, "cpu")
    batch = {k_: v[:256] for k_, v in batch.items()}
    n = cell.meta.get("n_microbatches", 1)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = micro_value_and_grad(
            lambda p, b: mod.smoke_loss(p, cfg, b),
            L.to_device(state.params, dev), L.to_device(batch, dev), n)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=1e-5, atol=1e-5)
    _close_rel([g.cpu() for g in leaves(out["cuda"][1])],
               leaves(out["cpu"][1]))


# -- the MoE FFN: no kernel; the grouped path against the plain one ----------

MOE_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MOE_NAMES = ("router", "w1", "w2", "w3")


def _moe_layer(device, dtype):
    """A MoE layer at d = 256, 16 experts, top 4, d_expert = 128 (its
    leaves as ``lm.init`` draws them, in ``dtype``) and its config."""
    import dataclasses

    from repro_torch.models import lm

    cfg = lm.LMConfig(name="moe-card", n_layers=1, d_model=256, n_heads=4,
                      n_kv_heads=4, d_head=64, d_ff=128, vocab=64,
                      padded_vocab=64,
                      moe=lm.MoEConfig(n_experts=16, top_k=4, d_expert=128))
    cfg = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
    p = lm._layer(lm.init(_gen(), cfg), 0)
    return cfg, {k_: p[k_].to(device=device, dtype=dtype)
                 for k_ in MOE_NAMES}


def _moe_fwd_bwd(fn, cfg, p, x, cot):
    leaf = {k_: v.clone().requires_grad_(True) for k_, v in p.items()}
    xg = x.clone().requires_grad_(True)
    out, aux = fn(leaf, cfg, xg)
    ((out.float() * cot).sum() + aux).backward()
    return [out.detach(), aux.detach(), xg.grad] + \
        [leaf[k_].grad for k_ in MOE_NAMES]


@pytest.mark.parametrize("tokens", [512, 7])  # 7: fewer than the experts
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_matches_plain_on_the_card(cuda, dtype, tokens):
    """``lm._moe_grouped`` against ``lm._moe_ref`` on the card: the output
    within 1e-5 (f32) or 2e-2 (bf16) of its largest magnitude, the aux
    equal, every gradient (x, router, w1, w2, w3) within BWD_REL; a
    second grouped run bit for bit the first."""
    from repro_torch.models import lm

    cfg, p = _moe_layer(cuda, dtype)
    gen = _gen()
    x = torch.randn(1, tokens, cfg.d_model, generator=gen).to(cuda, dtype)
    cot = torch.randn(1, tokens, cfg.d_model, generator=gen).to(cuda)
    got = _moe_fwd_bwd(lm._moe_grouped, cfg, p, x, cot)
    want = _moe_fwd_bwd(lm._moe_ref, cfg, p, x, cot)
    scale = float(want[0].float().abs().max())
    assert float((got[0].float() - want[0].float()).abs().max()) <= \
        MOE_FWD_TOL[dtype] * scale
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    _close_rel(got[2:], want[2:])
    again = _moe_fwd_bwd(lm._moe_grouped, cfg, p, x, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_moe_grouped_card_vs_cpu(cuda):
    """The grouped path in f32 on the card and on the CPU, from the same
    inputs: output and gradients within 1e-5 of their largest
    magnitude, the same experts picked."""
    from repro_torch.models import lm

    cfg, p = _moe_layer("cpu", torch.float32)
    gen = _gen()
    x = torch.randn(2, 300, cfg.d_model, generator=gen)
    cot = torch.randn(2, 300, cfg.d_model, generator=gen)
    want = _moe_fwd_bwd(lm._moe_grouped, cfg, p, x, cot)
    got = _moe_fwd_bwd(lm._moe_grouped, cfg,
                       {k_: v.to(cuda) for k_, v in p.items()}, x.to(cuda),
                       cot.to(cuda))
    assert torch.equal(
        lm._route(p, cfg, x.reshape(-1, cfg.d_model))[2],
        lm._route({k_: v.to(cuda) for k_, v in p.items()}, cfg,
                  x.to(cuda).reshape(-1, cfg.d_model))[2].cpu())
    for g, w in zip(got, want):
        scale = float(w.abs().max()) or 1.0
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale
