"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Run on the card:
    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# fp32 on both sides; sinf and the order of the conv sums differ
ATOL = RTOL = 1e-4


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
