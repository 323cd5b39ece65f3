"""The port's ops against the JAX package's on the same numpy inputs (CPU,
fp32).  Covers the plain versions of the two CUDA kernels (K1 alias-free
Snake, K2 residual unit) and the index arithmetic the kernels use at the
global edges."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flamed_tts_tpu.models.facodec.encoder import residual_unit_xla
from flamed_tts_tpu.ops import conv1d as jconv
from flamed_tts_tpu.ops import embeddings as jemb
from flamed_tts_tpu.ops.length_regulator import length_regulate as j_length_regulate
from flamed_tts_tpu.ops.norms import masked_group_norm as j_masked_group_norm
from flamed_tts_tpu.ops.resample import kaiser_sinc_filter1d as j_kaiser
from flamed_tts_tpu.ops.resample import snake_filtered_reference as j_snake_ref

from flamed_tts_tpu_torch.ops import conv1d as tconv
from flamed_tts_tpu_torch.ops import embeddings as temb
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.norms import masked_group_norm
from flamed_tts_tpu_torch.ops.resample import kaiser_sinc_filter1d, snake_filtered_reference, snake_taps
from flamed_tts_tpu_torch.ops.resunit import residual_stack, residual_unit, residual_unit_reference
from flamed_tts_tpu_torch.ops.snake import snake_filtered

# The kernel-bearing ops hold to the JAX chain at 1e-5 (the tolerance of
# the JAX package's own kernel tests): same fp32 math, only the summation
# order of the FIR and conv taps differs.
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kaiser_filter_matches():
    for args in [(0.25, 0.3, 12), (0.5, 0.6, 12), (0.1, 0.2, 7)]:
        np.testing.assert_array_equal(kaiser_sinc_filter1d(*args), j_kaiser(*args))


@pytest.mark.parametrize("t_len,c", [(20, 8), (300, 16), (511, 32), (257, 64), (130, 128)])
def test_snake_filtered_plain_matches_jax(t_len, c):
    rng = np.random.RandomState(3)
    x = rng.randn(2, t_len, c).astype(np.float32)
    a = (rng.randn(c) * 0.1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    ref = np.asarray(j_snake_ref(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    out = snake_filtered_reference(_t(x), _t(a), _t(b)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # CPU dispatch of the kernel wrapper is the plain chain
    np.testing.assert_array_equal(snake_filtered(_t(x), _t(a), _t(b)).numpy(), out)


def _kernel_index_math(x, log_a, log_b):
    """The formula of csrc/snake.cuh in numpy: polyphase 2x values at
    clamped indices, decimation at clamped 2x-rate indices."""
    t_len = x.shape[0]
    f = snake_taps().astype(np.float64)
    alpha, inv_beta = np.exp(log_a), 1.0 / (np.exp(log_b) + 1e-9)

    def s(i):
        p, odd = i >> 1, i & 1
        u = sum(f[2 * k + 1 - odd] * x[min(max(p + 2 + odd - k, 0), t_len - 1)] for k in range(6))
        u = 2.0 * u
        return u + inv_beta * np.sin(u * alpha) ** 2

    return np.stack([
        sum(f[j] * s(min(max(2 * t + j - 5, 0), 2 * t_len - 1)) for j in range(12))
        for t in range(t_len)
    ])


@pytest.mark.parametrize("t_len", [1, 2, 5, 20, 41])
def test_snake_kernel_index_math_matches_chain(t_len):
    """Every row, the global edges included, follows from the clamped
    indices alone: the kernel needs no host-side edge patch."""
    rng = np.random.RandomState(t_len)
    x = rng.randn(t_len, 4)
    a, b = rng.randn(4) * 0.3, rng.randn(4) * 0.3
    ref = snake_filtered_reference(_t(x[None]), _t(a), _t(b))[0].numpy()
    np.testing.assert_allclose(_kernel_index_math(x, a, b), ref, atol=1e-12, rtol=1e-12)


def _unit_params(rng, c):
    def v(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return {
        "act1": {"alpha": v(c), "beta": v(c)},
        "act2": {"alpha": v(c), "beta": v(c)},
        "conv1": {"w": v(c, c, 7), "b": v(c)},
        "conv2": {"w": v(c, c, 1), "b": v(c)},
    }


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


# T = 20 at d = 9 is shorter than twice the unit's halo (3d + 12 = 39).
@pytest.mark.parametrize("t_len,c,d", [(300, 16, 1), (300, 16, 3), (290, 16, 9), (140, 32, 1),
                                       (20, 32, 9), (7, 8, 3)])
def test_residual_unit_plain_matches_jax(t_len, c, d):
    rng = np.random.RandomState(5)
    p = _unit_params(rng, c)
    x = rng.randn(2, t_len, c).astype(np.float32)
    ref = np.asarray(residual_unit_xla(jnp.asarray(x), _tree(p, jnp.asarray), d))
    pt = _tree(p, _t)
    out = residual_unit_reference(_t(x), pt, d).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(residual_unit(_t(x), pt, d).numpy(), out)


def test_residual_stack_runs_three_units():
    rng = np.random.RandomState(6)
    units = [_tree(_unit_params(rng, 8), _t) for _ in range(3)]
    x = _t(rng.randn(1, 50, 8).astype(np.float32))
    want = x
    for p, d in zip(units, (1, 3, 9)):
        want = residual_unit_reference(want, p, d)
    torch.testing.assert_close(residual_stack(x, units), want, rtol=0, atol=0)


def test_conv_ops_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 37, 6).astype(np.float32)
    w = rng.randn(5, 6, 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    for kw in [dict(), dict(stride=2, padding=3), dict(padding=2, dilation=3)]:
        ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
        np.testing.assert_allclose(tconv.conv1d(_t(x), _t(w), _t(b), **kw).numpy(), ref, **TOL)
    wt = rng.randn(6, 3, 10).astype(np.float32)
    bt = rng.randn(3).astype(np.float32)
    ref = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bt),
                                            stride=5, padding=3, output_padding=1))
    out = tconv.conv_transpose1d(_t(x), _t(wt), _t(bt), stride=5, padding=3, output_padding=1)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_array_equal(tconv.replicate_pad(_t(x), 3, 4).numpy(),
                                  np.asarray(jconv.replicate_pad(jnp.asarray(x), 3, 4)))


def test_embeddings_match_jax():
    np.testing.assert_allclose(temb.sinusoid_position_table(50, 12).numpy(),
                               np.asarray(jemb.sinusoid_position_table(50, 12)), atol=1e-6)
    t = np.array([0.0, 0.3, 0.97], np.float32)
    np.testing.assert_allclose(temb.flow_time_embedding(_t(t), 16).numpy(),
                               np.asarray(jemb.flow_time_embedding(jnp.asarray(t), 16)), atol=1e-4)
    np.testing.assert_allclose(temb.dit_timestep_embedding(_t(t), 15).numpy(),
                               np.asarray(jemb.dit_timestep_embedding(jnp.asarray(t), 15)), atol=1e-5)


def test_length_regulate_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 7, 5).astype(np.float32)
    dur = rng.randint(0, 4, (2, 7)).astype(np.float32)
    sil = rng.randint(0, 3, (2, 7)).astype(np.float32)
    lens = np.array([7, 4], np.int64)
    for max_len in (40, 9):
        ref, ref_len = j_length_regulate(jnp.asarray(x), jnp.asarray(dur), jnp.asarray(sil),
                                         jnp.asarray(lens.astype(np.int32)), max_len)
        out, out_len = length_regulate(_t(x), _t(dur), _t(sil), _t(lens), max_len)
        np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_masked_group_norm_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 11, 16).astype(np.float32) * 3 + 1
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    mask = np.arange(11)[None, :] >= np.array([11, 6])[:, None]
    for m in (None, mask):
        ref = j_masked_group_norm(jnp.asarray(x), 4, jnp.asarray(scale), jnp.asarray(bias),
                                  None if m is None else jnp.asarray(m))
        out = masked_group_norm(_t(x), 4, _t(scale), _t(bias), None if m is None else _t(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
