"""K2 at every width the FaCodec redecoder builds at its reference width
(``upsample_initial_channel`` 1280: blocks of 640, 320, 160 and 80
channels), on the CPU: the tile chooser and the wrapper's checks take the
widths and hand the launch what the kernel takes (a width of 16 mod 32
zero-padded to the next multiple of 32, the dilated conv's weights packed
pass by pass past 512 float32 channels), the zero pad leaves the real
channels' plain result as it is, and the port's redecoder at 1280 channels
equals the JAX package's on a short input."""

import jax
import numpy as np
import pytest
import torch

from flamed_tts_tpu.models.facodec import extras as jx

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.convert import codec_tree, params_to_jax
from flamed_tts_tpu_torch.models.facodec import extras
from flamed_tts_tpu_torch.ops import resunit

# the redecoder's K2 shapes for a 3 s source at 1280 channels: 150 frames up 8x, 5x, 5x, 4x
REDECODER_SHAPES = [(1200, 640), (6000, 320), (24000, 160), (48000, 80)]


def _unit(rng, c, dtype=torch.float32):
    def r(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dtype)

    s = 1.0 / np.sqrt(7 * c)
    return {"act1": {"alpha": r(c, scale=0.3).float(), "beta": r(c, scale=0.3).float()},
            "act2": {"alpha": r(c, scale=0.3).float(), "beta": r(c, scale=0.3).float()},
            "conv1": {"w": r(c, c, 7, scale=s), "b": r(c, scale=0.1)},
            "conv2": {"w": r(c, c, 1, scale=s), "b": r(c, scale=0.1)}}


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t_len,c", REDECODER_SHAPES)
def test_pick_tile_takes_the_redecoder_widths(t_len, c, itemsize):
    cw = resunit.kernel_width(c)
    assert cw == (96 if c == 80 else c)
    for d in (1, 3, 9):
        tile = resunit.pick_tile(t_len, cw, d, itemsize)
        assert (tile + 12) % resunit.MMA_M == 0
        assert resunit.unit_smem_bytes(cw, d, tile, itemsize) <= resunit.SMEM_LIMIT
    # float32 past 512 channels reduces in two passes; nothing else splits
    assert resunit.unit_passes(cw, itemsize) == (2 if (c, itemsize) == (640, 4) else 1)


def test_kernel_width_refuses_what_k2_does_not_take():
    for c in (8, 24, 88, 656, 672):
        with pytest.raises(ValueError, match="multiple of 16"):
            resunit.kernel_width(c)
    assert [resunit.kernel_width(c) for c in (16, 32, 48, 80, 512, 528, 640)] == [32, 32, 64, 96, 512,
                                                                                 544, 640]


def test_pass_packing_is_the_slices_packed_one_after_the_other():
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(640, 640, 7).astype(np.float32))
    packed = resunit.pack_mma_weights(w, 2)
    assert tuple(packed.shape) == resunit.packed_shape(640, 7, torch.float32)
    assert torch.equal(packed[:280], resunit.pack_mma_weights(w[:, :320].contiguous()))
    assert torch.equal(packed[280:], resunit.pack_mma_weights(w[:, 320:].contiguous()))
    assert torch.equal(resunit.unpack_mma_weights(packed, 7, 2), w)


def test_zero_pad_keeps_the_real_channels():
    """The plain unit on x and the parameters zero-padded from 80 to 96
    channels: the pad channels come out exactly zero and the real ones as
    the unpadded unit's (the same sums with exact zero terms added)."""
    rng = np.random.RandomState(1)
    p = _unit(rng, 80)
    x = torch.from_numpy(rng.randn(2, 300, 80).astype(np.float32))
    for d in (1, 3, 9):
        ref = resunit.residual_unit_reference(x, p, d)
        padded = resunit.residual_unit_reference(torch.nn.functional.pad(x, (0, 16)),
                                                 resunit.pad_unit(p, 96), d)
        assert torch.equal(padded[..., 80:], torch.zeros_like(padded[..., 80:]))
        torch.testing.assert_close(padded[..., :80], ref, atol=1e-6, rtol=1e-6)


class _FakeLibrary:
    """Stands in for the built K2 library: records each launch's scalar
    arguments and operands, returns success and writes nothing."""

    def __init__(self):
        self.calls = []

    def residual_unit_launch(self, x, ops, out, b, t, c, d, tile, bf16, stream):
        self.calls.append({"b": b, "t": t, "c": c, "d": d, "tile": tile, "bf16": bf16,
                           "ops": [ops[i] for i in range(8)]})
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t_len,c", REDECODER_SHAPES)
def test_wrapper_checks_take_the_redecoder_widths(monkeypatch, t_len, c, dtype):
    """The wrapper's checks on CPU tensors (the device check stood in):
    every redecoder width reaches the launch, at the width the kernel takes
    and the tile ``pick_tile`` gives, with operands of the packed shapes;
    the output has the caller's width."""
    fake = _FakeLibrary()
    require = kernels.require
    monkeypatch.setattr(kernels, "require", lambda t, *a, **k: require(_AsCuda(t), *a, **k))
    monkeypatch.setattr(kernels, "library", lambda name: fake)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: 0)
    monkeypatch.setattr(kernels, "pointers", lambda ts: [t for t in ts])
    rng = np.random.RandomState(c)
    p = _unit(rng, c, dtype)
    x = torch.zeros(1, t_len, c, dtype=dtype)
    cw = resunit.kernel_width(c)
    itemsize = x.element_size()
    for d in (1, 3, 9):
        for prepared in (None, resunit.prepare_unit(p)):
            out = resunit._unit_launch(x, p, d, prepared)
            assert out.shape == x.shape and out.dtype == dtype
            call = fake.calls[-1]
            assert (call["c"], call["t"], call["d"]) == (cw, t_len, d)
            assert call["tile"] == resunit.pick_tile(t_len, cw, d, itemsize)
            assert call["bf16"] == int(dtype == torch.bfloat16)
            w1, w2 = call["ops"][2], call["ops"][6]
            assert tuple(w1.shape) == resunit.packed_shape(cw, 7, dtype)
            assert tuple(w2.shape) == resunit.packed_shape(cw, 1, dtype)
            padded = resunit.pad_unit(p, cw)["conv1"]["w"]
            assert torch.equal(resunit.unpack_mma_weights(w1, 7, resunit.unit_passes(cw, itemsize)),
                               padded)


class _AsCuda:
    """A CPU tensor seen by ``kernels.require`` as a CUDA one: every other
    property is the tensor's own."""

    def __init__(self, t):
        self._t = t

    is_cuda = True

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_redecoder_at_its_reference_width_matches_jax():
    """The port's redecoder at 1280 channels (blocks of 640 ... 80) against
    the JAX package's on a short input, both on the CPU in fp32."""
    params = params_to_jax(extras.init_redecoder_params(torch.Generator().manual_seed(3)))
    params = jax.tree_util.tree_map(lambda a: a * 1e4 if a.shape == (1024, 256) else a, params)
    rng = np.random.RandomState(4)
    codes = rng.randint(0, 1024, (6, 1, 3)).astype(np.int32)
    spk = (rng.randn(1, 256) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, c, s: jx.redecoder_forward(p, c, s, True))(params, codes, spk))
    out = extras.redecoder_forward(codec_tree(params), torch.from_numpy(codes), torch.from_numpy(spk),
                                   True)
    assert out.shape == (1, 3 * 200, 1) and np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
