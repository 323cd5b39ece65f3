"""K3's plain version (``residual_stack_reference``) against the TPU kernel
it replaces, ``residual_stack_pallas``, run in Pallas interpret mode on the
CPU as tests/test_pallas_kernels.py runs it; and ``stack_tile``, the rule
that decides between one K3 launch and three K2 launches."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import flamed_tts_tpu.ops.pallas_resunit as pru

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops import resunit
from flamed_tts_tpu_torch.ops.resunit import (SMEM_LIMIT, residual_stack, residual_stack_cuda,
                                              residual_stack_reference, residual_unit_reference,
                                              stack_smem_bytes, stack_tile)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _units(rng, c):
    def v(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return [{"act1": {"alpha": v(c), "beta": v(c)}, "act2": {"alpha": v(c), "beta": v(c)},
             "conv1": {"w": v(c, c, 7), "b": v(c)}, "conv2": {"w": v(c, c, 1), "b": v(c)}}
            for _ in range(3)]


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


# the shapes of tests/test_pallas_kernels.py::test_fused_residual_stack_matches_xla
@pytest.mark.parametrize("t_len,c,tile", [
    (1400, 16, 512),    # unfolded, 3 tiles, partial last tile
    (610, 16, 512),     # unfolded, 2 tiles, tail inside the halo zone
    (1300, 64, 512),    # lane fold 2, 3 tiles
    (2300, 32, 640),    # lane fold 4, 4 tiles
])
def test_stack_plain_matches_pallas_stack(interpret_mode, t_len, c, tile):
    rng = np.random.RandomState(11 + t_len)
    units = _units(rng, c)
    x = rng.randn(2, t_len, c).astype(np.float32)
    ref = np.asarray(pru.residual_stack_pallas(jnp.asarray(x), _tree(units, jnp.asarray),
                                               (1, 3, 9), tile=tile))
    out = residual_stack_reference(torch.from_numpy(x), _tree(units, torch.from_numpy))
    # fp32 both sides; the tolerance the Pallas kernel is held to against its own XLA chain
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("t_len,c", [(1, 8), (60, 8), (149, 32)])
def test_stack_plain_matches_jax_on_short_inputs(interpret_mode, t_len, c):
    """Below twice its halo (150 rows) the JAX wrapper runs the units one by
    one; the port's stack has no such threshold and must agree there too."""
    rng = np.random.RandomState(12 + t_len)
    units = _units(rng, c)
    x = rng.randn(1, t_len, c).astype(np.float32)
    ref = np.asarray(pru.residual_stack_pallas(jnp.asarray(x), _tree(units, jnp.asarray)))
    out = residual_stack_reference(torch.from_numpy(x), _tree(units, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_stack_plain_is_three_unit_calls(dtype):
    rng = np.random.RandomState(13)
    units = _tree(_tree(_units(rng, 32), torch.from_numpy), lambda t: t.to(dtype))
    x = torch.from_numpy(rng.randn(2, 200, 32).astype(np.float32)).to(dtype)
    chain = x
    for p, d in zip(units, (1, 3, 9)):
        chain = residual_unit_reference(chain, p, d)
    out = residual_stack_reference(x, units)
    assert out.dtype == dtype and torch.equal(out, chain)
    # on a CPU tensor both settings of the dispatcher are the plain chain
    kernels.reset_launches()
    assert torch.equal(residual_stack(x, units, fuse=True), chain)
    assert torch.equal(residual_stack(x, units, fuse=False), chain)
    assert not any(kernels.launches.values())


STACK_TILES = {  # (C, dtype) -> rows per K3 block, None where K2 takes the units
    (32, torch.float32): 256, (64, torch.float32): 112, (128, torch.float32): None,
    (256, torch.float32): None, (512, torch.float32): None,
    (32, torch.bfloat16): 256, (64, torch.bfloat16): 256, (128, torch.bfloat16): 112,
    (256, torch.bfloat16): None, (512, torch.bfloat16): None,
}


@pytest.mark.parametrize("c,dtype", list(STACK_TILES), ids=lambda v: str(v).replace("torch.", ""))
def test_stack_tile_table(c, dtype):
    tile = stack_tile(c, dtype)
    assert tile == STACK_TILES[(c, dtype)]
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if tile is None:
        # not even the smallest useful tile fits one block's shared memory
        assert stack_smem_bytes(c, resunit.STACK_MIN_TILE, itemsize) > SMEM_LIMIT
    else:
        assert stack_smem_bytes(c, tile, itemsize) <= SMEM_LIMIT == 232448
        assert tile % 16 == 0 and resunit.STACK_MIN_TILE <= tile <= resunit.STACK_MAX_TILE
        # the next tile up does not fit, or is past the cap
        assert tile == resunit.STACK_MAX_TILE or stack_smem_bytes(c, tile + 16, itemsize) > SMEM_LIMIT


def test_stack_smem_formula():
    # Y (tile + 120 rows) + H1 (tile + 138) + H2 (tile + 132) at dilations (1, 3, 9),
    # rows of C values and 16 bytes, plus two 16 KB weight stages
    for c, tile in [(32, 256), (64, 112), (64, 160)]:
        assert stack_smem_bytes(c, tile, 4) == (3 * tile + 390) * (c + 4) * 4 + 2 * 16384
    for c, tile in [(32, 256), (128, 112), (128, 160)]:
        assert stack_smem_bytes(c, tile, 2) == (3 * tile + 390) * (c + 8) * 2 + 2 * 16384


def test_stack_tile_is_a_pure_function_of_width_and_type():
    assert stack_tile(48, torch.float32) is None       # not a multiple of 32
    assert stack_tile(64, torch.float16) is None       # not an io type of the kernels
    assert stack_tile(64, torch.float64) is None
    assert stack_tile(0, torch.float32) is None
    assert [stack_tile(64, torch.float32) for _ in range(3)] == [112] * 3


def test_stack_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.RandomState(14)
    units = _tree(_units(rng, 32), torch.from_numpy)
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        residual_stack_cuda(x, units)
    with pytest.raises(ValueError, match="C % 32"):
        residual_stack_cuda(torch.zeros(1, 8, 16), units)
    with pytest.raises(ValueError, match="x must be"):
        residual_stack_cuda(torch.zeros(8, 32), units)
