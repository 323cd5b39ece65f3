"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Run on the card:
    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

from unittest import mock

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# fp32 on both sides; sinf and the order of the conv sums differ
ATOL = RTOL = 1e-4
# bf16 io: kernel and plain version round at the same places, but their
# fp32 sums differ in order, so a value near a rounding boundary may land
# one bf16 step away and the step then feeds the next stage.  An element
# may be off by BF16_ULPS steps of 2^-7 relative to max(|ref|, mean |ref|).
BF16_ULPS = 8


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flamed_tts_tpu_torch import kernels

    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("t_len,c", [(1, 64), (2, 64), (5, 64), (20, 64), (300, 16),
                                     (2000, 512), (4097, 96)])
def test_snake_filtered_kernel(device, t_len, c):
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    rng = np.random.RandomState(t_len + c)
    x, a, b = (_rand(rng, 2, t_len, c).to(device), _rand(rng, c, scale=0.3).to(device),
               _rand(rng, c, scale=0.3).to(device))
    torch.testing.assert_close(snake_filtered_cuda(x, a, b), snake_filtered_reference(x, a, b),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t_len,c,d", [(30, 32, 9), (3000, 32, 1), (2000, 512, 9),
                                       (1000, 64, 3), (517, 128, 9), (700, 256, 1)])
def test_residual_unit_kernel(device, t_len, c, d):
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference

    rng = np.random.RandomState(t_len + c + d)
    s = 1.0 / np.sqrt(7 * c)
    p = {"act1": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "act2": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "conv1": {"w": _rand(rng, c, c, 7, scale=s), "b": _rand(rng, c, scale=0.1)},
         "conv2": {"w": _rand(rng, c, c, 1, scale=s), "b": _rand(rng, c, scale=0.1)}}
    p = {k: {n: v.to(device) for n, v in sub.items()} for k, sub in p.items()}
    x = _rand(rng, 2, t_len, c).to(device)
    torch.testing.assert_close(residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d),
                               atol=ATOL, rtol=RTOL)


def _unit_params(rng, c, device, dtype=torch.float32):
    s = 1.0 / np.sqrt(7 * c)
    p = {"act1": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "act2": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "conv1": {"w": _rand(rng, c, c, 7, scale=s).to(dtype), "b": _rand(rng, c, scale=0.1).to(dtype)},
         "conv2": {"w": _rand(rng, c, c, 1, scale=s).to(dtype), "b": _rand(rng, c, scale=0.1).to(dtype)}}
    return {k: {n: v.to(device) for n, v in sub.items()} for k, sub in p.items()}


def _assert_bf16_close(out, ref):
    assert out.dtype == ref.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    step = 2.0 ** -7 * torch.maximum(ref.abs(), ref.abs().mean())
    ulps = ((out - ref).abs() / step).max().item()
    assert ulps <= BF16_ULPS, f"{ulps:.2f} bf16 steps off"


@pytest.mark.parametrize("t_len,c", [(1, 64), (5, 64), (300, 32), (2000, 512), (4097, 96)])
def test_snake_filtered_kernel_bf16(device, t_len, c):
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    rng = np.random.RandomState(t_len + c)
    x = _rand(rng, 2, t_len, c).to(device).bfloat16()
    a, b = _rand(rng, c, scale=0.3).to(device), _rand(rng, c, scale=0.3).to(device)
    _assert_bf16_close(snake_filtered_cuda(x, a, b), snake_filtered_reference(x, a, b))


@pytest.mark.parametrize("t_len,c,d", [(30, 32, 9), (3000, 32, 1), (1000, 512, 9), (1000, 64, 3),
                                       (517, 128, 9), (700, 256, 1)])
def test_residual_unit_kernel_bf16(device, t_len, c, d):
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference

    rng = np.random.RandomState(t_len + c + d)
    p = _unit_params(rng, c, device, torch.bfloat16)
    x = _rand(rng, 2, t_len, c).to(device).bfloat16()
    _assert_bf16_close(residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d))


STACK_SHAPES = [(1, 32), (30, 64), (149, 32), (151, 64), (1000, 32), (777, 64), (3000, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t_len,c", STACK_SHAPES)
def test_residual_stack_kernel(device, t_len, c, dtype):
    """K3 against its plain version, and bit for bit against three K2
    launches, at every (C, dtype) stack_tile admits."""
    from flamed_tts_tpu_torch.ops.resunit import (residual_stack_cuda, residual_stack_reference,
                                                  residual_unit_cuda, stack_tile)

    rng = np.random.RandomState(t_len + c)
    units = [_unit_params(rng, c, device, dtype) for _ in range(3)]
    x = _rand(rng, 2, t_len, c).to(device).to(dtype)
    if stack_tile(c, dtype) is None:
        with pytest.raises(ValueError, match="does not fit"):
            residual_stack_cuda(x, units)
        return
    out = residual_stack_cuda(x, units)
    chain = x
    for p, d in zip(units, (1, 3, 9)):
        chain = residual_unit_cuda(chain, p, d)
    torch.cuda.synchronize()
    assert torch.equal(out, chain)
    ref = residual_stack_reference(x, units)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    else:
        _assert_bf16_close(out, ref)


def test_residual_stack_smem_formula_matches_the_source(device):
    from flamed_tts_tpu_torch import kernels
    from flamed_tts_tpu_torch.ops.resunit import stack_smem_bytes, unit_smem_bytes

    fn = kernels.library("residual_stack").residual_stack_smem_bytes
    unit_fn = kernels.library("residual_unit").residual_unit_smem_bytes
    for c in (32, 64, 128):
        for tile in (64, 160, 256):
            for itemsize in (2, 4):
                assert fn(c, tile, 1, 3, 9, itemsize) == stack_smem_bytes(c, tile, itemsize)
    for c in (32, 96, 512):
        for d in (1, 3, 9):
            for tile in (4, 12, 52, 116):
                for itemsize in (2, 4):
                    assert unit_fn(c, d, tile, itemsize) == unit_smem_bytes(c, d, tile, itemsize)


# rows that end inside an mma tile of 16: one row, one short of and one past a
# tile, the same around three tiles, and a length no K2 or K3 tile divides
MMA_PADDING_T = [1, 15, 17, 47, 49, 333]


@pytest.mark.parametrize("c", [32, 96, 512])
@pytest.mark.parametrize("t_len", MMA_PADDING_T)
def test_mma_padding_shapes_bf16(device, t_len, c):
    """K2 in bf16 at lengths that leave the last mma tile ragged, at
    dilations 1, 3, 9: against its plain version, and with the same bits
    from another tile; K3 bit for bit equal to the three K2 launches where
    stack_tile admits the width."""
    from flamed_tts_tpu_torch.ops import resunit
    from flamed_tts_tpu_torch.ops.resunit import (pick_tile, prepare_unit, residual_stack_cuda,
                                                  residual_stack_reference, residual_unit_cuda,
                                                  residual_unit_reference, stack_tile)

    rng = np.random.RandomState(7 * t_len + c)
    units = [_unit_params(rng, c, device, torch.bfloat16) for _ in range(3)]
    x = _rand(rng, 2, t_len, c).to(device).bfloat16()
    chain = x
    for p, d in zip(units, (1, 3, 9)):
        out = residual_unit_cuda(chain, p, d)
        _assert_bf16_close(out, residual_unit_reference(chain, p, d))
        other = 36 if pick_tile(t_len, c, d, 2) != 36 else 20
        with mock.patch.object(resunit, "pick_tile", lambda *a: other):
            assert torch.equal(out, residual_unit_cuda(chain, p, d))
        assert torch.equal(out, residual_unit_cuda(chain, p, d, prepared=prepare_unit(p)))
        chain = out
    if stack_tile(c, torch.bfloat16) is None:
        with pytest.raises(ValueError, match="does not fit"):
            residual_stack_cuda(x, units)
        return
    out = residual_stack_cuda(x, units)
    torch.cuda.synchronize()
    assert torch.equal(out, chain)
    assert torch.equal(out, residual_stack_cuda(x, units, prepared=[prepare_unit(p) for p in units]))
    _assert_bf16_close(out, residual_stack_reference(x, units))


def test_bf16_kernels_refuse_a_width_past_the_weight_stage(device):
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda

    rng = np.random.RandomState(3)
    p = _unit_params(rng, 544, device, torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        residual_unit_cuda(_rand(rng, 1, 40, 544).to(device).bfloat16(), p, 1)
