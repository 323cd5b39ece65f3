"""The host side of the tensor-core convs of K2 and K3: the packing of the
weights into mma B fragments (the bfloat16 order here, the float32 order in
tests/test_torch_tf32_layout.py), the tile choosers, the shared-memory
formulas, and the kernel-layout weights ``FaCodec`` keeps beside its
parameters.  All on the CPU; the kernels themselves are held to the plain
versions in tests/test_torch_cuda_kernels.py on the card."""

import numpy as np
import pytest
import torch

from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.ops import resunit
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resunit import (MMA_M, SMEM_LIMIT, pack_mma_weights, packed_shape,
                                              pick_tile, prepare_unit, residual_stack,
                                              residual_stack_reference, residual_unit, stack_smem_bytes,
                                              stack_tile, unit_smem_bytes, unpack_mma_weights)

# (T, C) of every residual unit on the two main paths of the smoke run: the
# encoder over a 3 s prompt, the decoder over 256 and over 512 frames
MAIN_PATH_SHAPES = [(48000, 32), (24000, 64), (6000, 128), (1200, 256),
                    (1280, 512), (6400, 256), (25600, 128), (51200, 64),
                    (2560, 512), (12800, 256), (51200, 128), (102400, 64)]


def _units(rng, c, dtype=torch.float32):
    def v(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32))

    return [{"act1": {"alpha": v(c), "beta": v(c)}, "act2": {"alpha": v(c), "beta": v(c)},
             "conv1": {"w": v(c, c, 7).to(dtype), "b": v(c).to(dtype)},
             "conv2": {"w": v(c, c, 1).to(dtype), "b": v(c).to(dtype)}} for _ in range(3)]


@pytest.mark.parametrize("k", [7, 1])
@pytest.mark.parametrize("c", [32, 96, 512])
def test_pack_round_trips_and_permutes(c, k):
    # bfloat16 holds the integers up to 256: position i carries i % 251 and i // 251 % 251
    # in two tensors, which together name the position
    i = torch.arange(c * c * k).reshape(c, c, k)
    lo, hi = (i % 251).to(torch.bfloat16), (i // 251 % 251).to(torch.bfloat16)
    packed_lo, packed_hi = pack_mma_weights(lo), pack_mma_weights(hi)
    assert packed_lo.shape == (k * c // 16, c // 16, 32, 8) == packed_shape(c, k, torch.bfloat16)
    assert packed_lo.is_contiguous() and packed_lo.dtype == torch.bfloat16
    assert torch.equal(unpack_mma_weights(packed_lo, k), lo) and torch.equal(unpack_mma_weights(packed_hi, k), hi)
    # every position exactly once
    where = (packed_lo.float() + 251 * packed_hi.float()).flatten().long()
    assert torch.equal(where.sort().values % (251 * 251), (torch.arange(c * c * k) % (251 * 251)).sort().values)


@pytest.mark.parametrize("c", [32, 96])
def test_packed_order_is_the_mma_b_fragment(c):
    """Slab s = tap * C / 16 + ci / 16, block co / 16, lane l, value e: the
    lane's registers b0 (e 0, 1), b1 (e 2, 3) of the n8 tile h = 0, then of
    h = 1, holding rows ci % 16 = 2 (l % 4) + {0, 1} (+ 8 for b1) of column
    co % 16 = 8 h + l // 4, as mma.sync m16n8k16 wants its B operand."""
    rng = np.random.RandomState(c)
    w = torch.from_numpy(rng.randn(c, c, 7).astype(np.float32)).bfloat16()
    packed = pack_mma_weights(w)
    s, n16, lane, e = np.meshgrid(np.arange(7 * c // 16), np.arange(c // 16), np.arange(32),
                                  np.arange(8), indexing="ij")
    tap, cib = s // (c // 16), s % (c // 16)
    h, reg, half = e // 4, (e % 4) // 2, e % 2
    ci = cib * 16 + (lane % 4) * 2 + half + 8 * reg
    co = n16 * 16 + h * 8 + lane // 4
    assert torch.equal(packed, w[torch.from_numpy(co), torch.from_numpy(ci), torch.from_numpy(tap)])


@pytest.mark.parametrize("c,dil", [(32, 1), (96, 3), (64, 9)])
def test_slab_order_product_is_the_conv(c, dil):
    """The implicit GEMM the kernel runs, emulated: for each slab in order,
    A = the input rows shifted by tap * dil, 16 channels wide, times the
    slab's 16 x C block read back from the packed order."""
    rng = np.random.RandomState(dil)
    rows = 40
    w = (torch.from_numpy(rng.randn(c, c, 7).astype(np.float32)) / np.sqrt(7 * c)).bfloat16()
    x = torch.from_numpy(rng.randn(rows + 6 * dil, c).astype(np.float32))  # zero pad not needed: valid rows only
    packed = pack_mma_weights(w)
    blocks = unpack_mma_weights(packed, 7).permute(2, 1, 0).float()  # [tap][ci][co]
    acc = torch.zeros(rows, c)
    for s in range(packed.shape[0]):
        tap, cib = divmod(s, c // 16)
        acc += x[tap * dil: tap * dil + rows, cib * 16: cib * 16 + 16] @ blocks[tap, cib * 16: cib * 16 + 16]
    ref = conv1d(x[None], w.float(), dilation=dil)[0]
    torch.testing.assert_close(acc, ref, atol=1e-5, rtol=1e-5)


def test_kernel_weights_layout_follows_the_type():
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(32, 32, 7).astype(np.float32))
    # a K step is 32 bytes of an activation row: 8 float32 or 16 bfloat16 input channels
    assert pack_mma_weights(w).shape == (28, 2, 32, 4) and pack_mma_weights(w).dtype == torch.float32
    assert pack_mma_weights(w.bfloat16()).shape == (14, 2, 32, 8)
    with pytest.raises(ValueError, match="multiples of 16"):
        pack_mma_weights(torch.zeros(24, 24, 7))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pack_mma_weights(w.double())
    p = _units(rng, 24)[0]
    assert prepare_unit(p) is None  # a width the kernels do not take


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t_len,c", MAIN_PATH_SHAPES)
def test_tile_choosers_on_the_main_paths(t_len, c, dtype):
    itemsize = 2 if dtype == torch.bfloat16 else 4
    for d in (1, 3, 9):
        tile = pick_tile(t_len, c, d, itemsize)
        assert 1 <= tile <= 100
        assert unit_smem_bytes(c, d, tile, itemsize) <= SMEM_LIMIT
        # the dilated conv's rows are whole mma tiles
        assert (tile + 12) % MMA_M == 0
    tile = stack_tile(c, dtype)
    if tile is not None:
        assert tile % MMA_M == 0 and stack_smem_bytes(c, tile, itemsize) <= SMEM_LIMIT
    else:
        assert stack_smem_bytes(c, resunit.STACK_MIN_TILE, itemsize) > SMEM_LIMIT


def test_pick_tile_values():
    # the largest tile up to 100 that gives 99 of the 132 SMs a block (and with
    # rows under 512 bytes two blocks an SM), else 20, else 4.  float32: rows are
    # twice as long, so C = 512 holds 96 rows, 20 output rows at d <= 3 and 4 at d = 9
    assert [pick_tile(48000, 32, d, 4) for d in (1, 3, 9)] == [100, 100, 100]
    assert [pick_tile(1280, 512, d, 4) for d in (1, 3, 9)] == [20, 20, 4]
    assert [pick_tile(6400, 256, d, 4) for d in (1, 3, 9)] == [52, 52, 52]
    assert [pick_tile(12800, 256, d, 4) for d in (1, 3, 9)] == [68, 68, 52]
    assert pick_tile(30, 64, 1, 4) == 20
    assert unit_smem_bytes(512, 9, 4, 4) <= SMEM_LIMIT < unit_smem_bytes(512, 9, 20, 4)
    # bfloat16
    assert [pick_tile(2560, 512, d, 2) for d in (1, 3, 9)] == [20, 20, 20]
    assert [pick_tile(1200, 256, d, 2) for d in (1, 3, 9)] == [20, 20, 20]
    assert [pick_tile(12800, 256, d, 2) for d in (1, 3, 9)] == [100, 100, 100]
    assert [pick_tile(6000, 128, d, 2) for d in (1, 3, 9)] == [52, 52, 52]
    assert [pick_tile(51200, 128, d, 2) for d in (1, 3, 9)] == [100, 100, 100]
    assert [pick_tile(102400, 64, d, 2) for d in (1, 3, 9)] == [100, 100, 100]
    assert pick_tile(1, 32, 1, 2) == 20
    # the largest tile that fits C = 512, d = 9 beside the weight stages
    assert unit_smem_bytes(512, 9, 52, 2) <= SMEM_LIMIT < unit_smem_bytes(512, 9, 68, 2)
    # past 512 float32 channels the dilated conv holds half of them at a time:
    # the redecoder's C = 640 takes 20 rows at every d, in both types
    assert [pick_tile(1200, 640, d, 4) for d in (1, 3, 9)] == [20, 20, 20]
    assert [pick_tile(1200, 640, d, 2) for d in (1, 3, 9)] == [20, 20, 20]
    with pytest.raises(ValueError, match="does not fit"):
        pick_tile(100, 672, 1, 2)  # past the widest conv the kernels take
    with pytest.raises(ValueError, match="does not fit"):
        pick_tile(100, 672, 1, 4)
    assert stack_tile(544, torch.bfloat16) is None and stack_tile(544, torch.float32) is None


def test_unit_smem_formula():
    # h1 (tile + 6 d + 12 rows) + h2 (tile + 12), rows of C values and 16 bytes, and
    # two 16 KB weight stages
    for c, d, tile in [(32, 1, 100), (512, 9, 4), (96, 3, 52)]:
        assert unit_smem_bytes(c, d, tile, 4) == (2 * tile + 6 * d + 24) * (c + 4) * 4 + 32768
        assert unit_smem_bytes(c, d, tile, 2) == (2 * tile + 6 * d + 24) * (c + 8) * 2 + 32768


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_prepared_weights_give_the_plain_result_on_the_cpu(dtype):
    rng = np.random.RandomState(4)
    units = _units(rng, 32, dtype)
    prepared = [prepare_unit(p) for p in units]
    assert all(w["w1"].dtype == dtype and w["w2"].dtype == dtype for w in prepared)
    x = torch.from_numpy(rng.randn(1, 90, 32).astype(np.float32)).to(dtype)
    ref = residual_stack_reference(x, units)
    for fuse in (False, True):
        assert torch.equal(residual_stack(x, units, fuse=fuse, prepared=prepared), ref)
    assert torch.equal(residual_unit(x, units[1], 3, prepared[1]), residual_unit(x, units[1], 3))


def test_codec_keeps_kernel_layout_weights_beside_its_parameters():
    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    latents = torch.from_numpy(rng.randn(1, 2, 256).astype(np.float32))
    timbre = torch.from_numpy(rng.randn(1, 256).astype(np.float32))

    def check(dtype):
        for params, prepared in ((codec.enc_params, codec.enc_prepared), (codec.dec_params, codec.dec_prepared)):
            assert len(prepared) == len(params["blocks"]) == 4
            for blk, ws in zip(params["blocks"], prepared):
                for unit, w in zip(blk["res"], ws):
                    assert w["w1"].dtype == w["w2"].dtype == dtype
                    assert torch.equal(w["w1"], pack_mma_weights(unit["conv1"]["w"]))
                    assert torch.equal(w["w2"], pack_mma_weights(unit["conv2"]["w"]))
                    assert "w1" not in unit and "kernel" not in unit  # beside the tree, not in it

    check(torch.float32)
    wav = codec.decode(latents, timbre)
    codec.cast_inference_params()
    check(torch.bfloat16)
    c = codec.dec_params["blocks"][0]["res"][0]["conv1"]["w"]
    assert torch.equal(unpack_mma_weights(codec.dec_prepared[0][0]["w1"], 7), c)
    out = codec.decode(latents, timbre)
    assert out.dtype == torch.bfloat16 and out.shape == wav.shape and torch.isfinite(out).all()
