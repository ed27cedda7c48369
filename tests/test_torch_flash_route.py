"""Which flash-attention kernel a call on the card runs, on the CPU.

``ops.flash_kernel`` reads only dtypes, shapes, strides and base
addresses, so its choice is tested here: bf16 goes to the wgmma kernel
(``flash_attention_wgmma``, TMA loads), f32 to the 3xTF32 one
(``flash_attention``, mma.sync, cp.async loads), and a bf16 call that
TMA cannot read raises with the rule it breaks instead of running the
other kernel.  On CPU tensors the wrapper runs the plain version
whatever the dtype, and counts no launch.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


def _qkv(dh, dtype, b=1, t=9, s=9, h=4, hk=2):
    g = torch.Generator().manual_seed(dh)
    return [torch.randn(*shape, generator=g).to(dtype)
            for shape in ((b, t, h, dh), (b, s, hk, dh), (b, s, hk, dh))]


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_bf16_goes_to_the_wgmma_kernel(dh):
    assert ops.flash_kernel(*_qkv(dh, torch.bfloat16)) == \
        "flash_attention_wgmma"


@pytest.mark.parametrize("dh", [8, 77, 256])
def test_f32_goes_to_the_3xtf32_kernel(dh):
    assert ops.flash_kernel(*_qkv(dh, torch.float32)) == "flash_attention"


@pytest.mark.parametrize("dh", [4, 77, 264])
def test_bf16_head_width_tma_cannot_read_raises(dh):
    with pytest.raises(ValueError, match="multiple of 8 in"):
        ops.flash_kernel(*_qkv(dh, torch.bfloat16))


def test_bf16_stride_off_16_bytes_raises():
    base = torch.zeros(1, 9, 4, 68, dtype=torch.bfloat16)
    q = base[..., :64]  # head stride 68 elements: 136 bytes
    k, v = _qkv(64, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops.flash_kernel(q, k, v)


def test_bf16_base_off_16_bytes_raises():
    flat = torch.zeros(1 + 9 * 4 * 64, dtype=torch.bfloat16)
    q = flat[1:].view(1, 9, 4, 64)  # 2 bytes past an aligned base
    assert q.data_ptr() % 16
    k, v = _qkv(64, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        ops.flash_kernel(q, k, v)


def test_bf16_views_tma_can_read_go_to_the_wgmma_kernel():
    """Views of one fused qkv (head stride dh, row stride 16 dh), a
    length-1 dimension with any stride, and a dh that is not contiguous
    (copied before the launch) all stay on the wgmma kernel."""
    qkv = torch.zeros(2, 50, 16, 32, dtype=torch.bfloat16)
    assert ops.flash_kernel(qkv[:, :, :8], qkv[:, :, 8:12],
                            qkv[:, :, 12:]) == "flash_attention_wgmma"
    one = torch.zeros(9 * 64, dtype=torch.bfloat16).as_strided(
        (1, 9, 1, 32), (3, 64, 5, 1))  # odd strides of length-1 dims
    q = _qkv(32, torch.bfloat16, h=2, hk=1)[0]
    assert ops.flash_kernel(q, one, one) == "flash_attention_wgmma"
    mt = torch.zeros(1, 9, 64, 4, dtype=torch.bfloat16).transpose(2, 3)
    assert mt.shape[-1] == 64 and mt.stride(-1) == 4
    assert ops.flash_kernel(mt, mt[:, :, :2], mt[:, :, :2]) == \
        "flash_attention_wgmma"


def test_bf16_on_the_cpu_runs_the_plain_version():
    x = _qkv(64, torch.bfloat16)
    before = dict(ops.LAUNCHES)
    kw = dict(window=5, softcap=50.0)
    torch.testing.assert_close(
        ops.flash_attention(*x, **kw),
        ref.flash_attention_ref(*x, scale=64 ** -0.5, **kw), rtol=0, atol=0)
    assert ops.LAUNCHES == before
