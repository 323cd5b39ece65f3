"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Run on the card:
    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

from unittest import mock

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# fp32 on both sides; the order of the sums differs, the kernels' sin^2 reduces
# its argument by the period pi, and their conv products are three TF32
# products of split operands (about 2^-21 of a product off)
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


# from (20, 8) on: the shapes the TPU kernel is held to in tests/test_pallas_kernels.py
# last: the first two encoder blocks' lengths of the precompute step's 17 s
# bucket, and one row short of the first
@pytest.mark.parametrize("t_len,c", [(1, 64), (2, 64), (5, 64), (20, 64), (300, 16),
                                     (2000, 512), (4097, 96), (20, 8), (511, 32), (257, 64),
                                     (130, 128), (272000, 32), (271999, 32), (136000, 64)])
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


@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
def test_residual_unit_kernel_fp32_widths(device, c, d):
    """The split-TF32 convs at every width and dilation of the codec, two
    batch rows, a length no tile divides."""
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference

    rng = np.random.RandomState(100 * c + d)
    p = _unit_params(rng, c, device)
    x = _rand(rng, 2, 333, c).to(device)
    torch.testing.assert_close(residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d),
                               atol=ATOL, rtol=RTOL)


def test_residual_unit_kernel_fp32_sums_of_one_sign(device):
    """Weights and input of one sign make every partial sum of the dilated
    conv grow with its length, 7 x 512 terms: a running sum kept on the
    tensor cores, which add by truncation, drifts out of the tolerance
    here."""
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference

    rng = np.random.RandomState(512)
    p = _unit_params(rng, 512, device)
    p["conv1"]["w"] = p["conv1"]["w"].abs()
    x = _rand(rng, 1, 200, 512).abs().to(device)
    ref = residual_unit_reference(x, p, 3)
    torch.testing.assert_close(residual_unit_cuda(x, p, 3), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("t_len,c", [(272000, 32), (271999, 32), (136000, 64)])
def test_residual_unit_kernel_at_precompute_lengths(device, t_len, c, d):
    """The encoder's first two blocks over a 17 s utterance (the precompute
    step's top bucket), two batch rows: grids of ~2700 blocks, and a length
    that leaves the last tile one row short."""
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference

    rng = np.random.RandomState(t_len % 1000 + c + d)
    p = _unit_params(rng, c, device)
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
    for c in (32, 96, 512, 640):
        for d in (1, 3, 9):
            for tile in (4, 12, 52, 116):
                for itemsize in (2, 4):
                    assert unit_fn(c, d, tile, itemsize) == unit_smem_bytes(c, d, tile, itemsize)


# rows that end inside an mma tile of 16: one row, one short of and one past a
# tile, the same around three tiles, and a length no K2 or K3 tile divides
MMA_PADDING_T = [1, 15, 17, 47, 49, 333]


def _assert_close(out, ref):
    if out.dtype == torch.bfloat16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


def _check_mma_padding_shapes(device, t_len, c, dtype):
    """K2 at a length that leaves the last mma tile ragged, at dilations 1,
    3, 9: against its plain version, and with the same bits from another
    tile; K3 bit for bit equal to the three K2 launches where stack_tile
    admits the width."""
    from flamed_tts_tpu_torch.ops import resunit
    from flamed_tts_tpu_torch.ops.resunit import (SMEM_LIMIT, pick_tile, prepare_unit,
                                                  residual_stack_cuda, residual_stack_reference,
                                                  residual_unit_cuda, residual_unit_reference,
                                                  stack_tile, unit_smem_bytes)

    itemsize = 2 if dtype == torch.bfloat16 else 4
    rng = np.random.RandomState(7 * t_len + c)
    units = [_unit_params(rng, c, device, dtype) for _ in range(3)]
    x = _rand(rng, 2, t_len, c).to(device).to(dtype)
    chain = x
    for p, d in zip(units, (1, 3, 9)):
        out = residual_unit_cuda(chain, p, d)
        _assert_close(out, residual_unit_reference(chain, p, d))
        # another tile that fits, a whole number of mma tiles or not
        other = next(tile for tile in (36, 20, 4, 7) if tile != pick_tile(t_len, c, d, itemsize)
                     and unit_smem_bytes(c, d, tile, itemsize) <= SMEM_LIMIT)
        with mock.patch.object(resunit, "pick_tile", lambda *a: other):
            assert torch.equal(out, residual_unit_cuda(chain, p, d))
        assert torch.equal(out, residual_unit_cuda(chain, p, d, prepared=prepare_unit(p)))
        chain = out
    if stack_tile(c, dtype) is None:
        with pytest.raises(ValueError, match="does not fit"):
            residual_stack_cuda(x, units)
        return
    out = residual_stack_cuda(x, units)
    torch.cuda.synchronize()
    assert torch.equal(out, chain)
    assert torch.equal(out, residual_stack_cuda(x, units, prepared=[prepare_unit(p) for p in units]))
    _assert_close(out, residual_stack_reference(x, units))


@pytest.mark.parametrize("c", [32, 96, 512])
@pytest.mark.parametrize("t_len", MMA_PADDING_T)
def test_mma_padding_shapes_bf16(device, t_len, c):
    _check_mma_padding_shapes(device, t_len, c, torch.bfloat16)


@pytest.mark.parametrize("c", [32, 64, 512])
@pytest.mark.parametrize("t_len", MMA_PADDING_T)
def test_mma_padding_shapes_fp32(device, t_len, c):
    _check_mma_padding_shapes(device, t_len, c, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_bf16_kernels_refuse_a_width_past_the_weight_stage(device, dtype):
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda

    # the weight stage holds any width since a pass streams only its items'
    # channel groups; what is refused is a width past MMA_MAX_C (640)
    rng = np.random.RandomState(3)
    p = _unit_params(rng, 672, device, dtype)
    with pytest.raises(ValueError, match="C <= 640"):
        residual_unit_cuda(_rand(rng, 1, 40, 672).to(device).to(dtype), p, 1)


# the FaCodec redecoder's blocks at its reference width (upsample_initial_channel
# 1280) for a 3 s source: 640 channels past 512 (fp32: the dilated conv in two
# passes), 80 channels of 16 mod 32 (zero-padded to 96 by the wrapper); short
# lengths here, the full ones in chip_smoke.py phase 2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("t_len,c", [(1200, 640), (333, 640), (4000, 80), (47, 80), (600, 320)])
def test_residual_unit_kernel_redecoder_widths(device, t_len, c, d, dtype):
    from flamed_tts_tpu_torch.ops import resunit
    from flamed_tts_tpu_torch.ops.resunit import (SMEM_LIMIT, kernel_width, pick_tile, prepare_unit,
                                                  residual_unit_cuda, residual_unit_reference,
                                                  unit_smem_bytes)

    rng = np.random.RandomState(t_len + c + d)
    p = _unit_params(rng, c, device, dtype)
    x = _rand(rng, 2, t_len, c).to(device).to(dtype)
    out = residual_unit_cuda(x, p, d)
    torch.cuda.synchronize()
    _assert_close(out, residual_unit_reference(x, p, d))
    assert torch.equal(out, residual_unit_cuda(x, p, d, prepared=prepare_unit(p)))
    # the same bits from another tile that fits
    itemsize = x.element_size()
    cw = kernel_width(c)
    other = next(tile for tile in (36, 4, 7) if tile != pick_tile(t_len, cw, d, itemsize)
                 and unit_smem_bytes(cw, d, tile, itemsize) <= SMEM_LIMIT)
    with mock.patch.object(resunit, "pick_tile", lambda *a: other):
        assert torch.equal(out, residual_unit_cuda(x, p, d))


@pytest.mark.parametrize("kernel", ["snake_filtered", "residual_unit", "residual_stack"])
def test_kernels_carry_autograd_on_the_card(device, kernel):
    """Under grad a CUDA float32 tensor that requires grad gets a result
    with a grad_fn, within tolerance of the plain chain, and its gradients
    (input and every parameter) equal autograd through the plain chain;
    under no_grad the same call launches without a Function."""
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.resunit import (residual_stack_cuda, residual_stack_reference,
                                                  residual_unit_cuda, residual_unit_reference)
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    rng = np.random.RandomState(5)
    c = 32
    p = {"act1": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "act2": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
         "conv1": {"w": _rand(rng, c, c, 7, scale=0.05), "b": _rand(rng, c, scale=0.1)},
         "conv2": {"w": _rand(rng, c, c, 1, scale=0.05), "b": _rand(rng, c, scale=0.1)}}
    p = {k: {n: v.to(device).requires_grad_() for n, v in sub.items()} for k, sub in p.items()}
    leaves = [t for sub in p.values() for t in sub.values()]
    kernel_call, plain_call = {
        "snake_filtered": (lambda x: snake_filtered_cuda(x, p["act1"]["alpha"], p["act1"]["beta"]),
                           lambda x: snake_filtered_reference(x, p["act1"]["alpha"], p["act1"]["beta"])),
        "residual_unit": (lambda x: residual_unit_cuda(x, p, 2), lambda x: residual_unit_reference(x, p, 2)),
        "residual_stack": (lambda x: residual_stack_cuda(x, [p, p, p]),
                           lambda x: residual_stack_reference(x, [p, p, p]))}[kernel]
    wrt = [p["act1"]["alpha"], p["act1"]["beta"]] if kernel == "snake_filtered" else leaves
    x = _rand(rng, 2, 300, c).to(device).requires_grad_()
    g = _rand(rng, 2, 300, c).to(device)
    out, ref = kernel_call(x), plain_call(x)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    # the same plain VJP at the same input: only cuDNN's backward algorithms
    # (split sums) part them, by a share of each leaf's scale
    for a, b in zip(torch.autograd.grad(out, [x, *wrt], g), torch.autograd.grad(ref, [x, *wrt], g)):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)
    with torch.no_grad():
        out = kernel_call(x)
    assert out.shape == x.shape and out.grad_fn is None and torch.isfinite(out).all()
