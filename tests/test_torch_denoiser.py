"""The denoiser's blocks over ``ops/denoiser.py``'s pieces on the CPU, where
each piece is its plain version: the output is what the op-by-op chain
computed, and a ``CostCounter`` counts the pieces as the card's launches.
(The kernels against these plain versions: tests/test_torch_denoiser_cuda.py.)"""

import numpy as np
import torch

from flamed_tts_tpu_torch.models.prob.prob_generator import SimpleMLPAdaLN
from flamed_tts_tpu_torch.ops import costs


def _denoiser():
    """A small denoiser (in 8, C 32, out 8, speaker 16, two blocks, k31)
    with seeded random parameters, and one call's inputs: two rows, the
    second padded from frame 25 on."""
    torch.manual_seed(0)
    den = SimpleMLPAdaLN(8, 32, 8, 16, 2)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for _, p in sorted(den.named_parameters()):
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * (0.3 if p.dim() > 1 else 0.5)).astype(np.float32)))
    x = torch.from_numpy(rng.randn(2, 40, 8).astype(np.float32))
    spk = torch.from_numpy(rng.randn(2, 16).astype(np.float32))
    mask = torch.zeros(2, 40, dtype=torch.bool)
    mask[1, 25:] = True
    return den, x, den.mods_at(torch.tensor([0.25, 0.7]), spk), mask


def test_plain_denoiser_output_is_unchanged():
    """The values the op-by-op chain of ``ops/convnext.py`` gave for this
    call before its blocks were split into the kernels' pieces.  The split
    keeps every op, but the products now leave their bias to the piece that
    reads them, and the final k3 conv is one product over its windows (as
    ``precision.conv1d`` computes it on the card): a value moves by a few
    units in its last place (at most 1.5e-5 of values up to 49; the sums by
    3e-8 of themselves), far inside the tolerances."""
    den, x, mods, mask = _denoiser()
    with torch.no_grad():
        out = den(x, mods, mask).double()
    np.testing.assert_allclose(out.sum(-1).sum(-1).numpy(), [-3347.9177899360657, -1496.0687673389912],
                               rtol=1e-6)
    np.testing.assert_allclose(float((out ** 2).sum()), 224633.4316135645, rtol=1e-6)
    rows = {(1, 24): [-30.05392074584961, -10.028024673461914, 18.396543502807617, 3.3580565452575684,
                      -5.38279390335083, 17.638338088989258, -23.59789276123047, -15.809782028198242],
            (1, 30): [-0.2690350115299225, -0.8462450504302979, 0.25056490302085876, 0.10211670398712158,
                      -0.34350350499153137, 0.13638930022716522, -0.2868409752845764, -0.5155555009841919],
            (0, 0): [-1.841050624847412, -32.641754150390625, 30.039932250976562, -21.32189178466797,
                     -39.76252746582031, -10.585611343383789, -19.0312442779541, 13.313942909240723]}
    for (b, t), want in rows.items():
        np.testing.assert_allclose(out[b, t].numpy(), want, rtol=1e-5, atol=1e-5)


def test_cost_counter_counts_the_pieces_as_launches():
    """Under a ``CostCounter`` each piece counts as one launch, on the CPU
    as on the card: per block two norm_modulate, one conv_norm, two act;
    the final layer two, one and one.  The operations are the products'
    and the depthwise convs' (2 K a value), as the counter counted the
    op-by-op chain."""
    den, x, mods, mask = _denoiser()
    n, c, k = x.shape[0] * x.shape[1], 32, 31
    with torch.no_grad(), costs.CostCounter() as cc:
        den(x, mods, mask)
    assert cc.kernels == {"norm_modulate": 6, "conv_norm": 3, "act": 5}
    products = 2 * n * (8 * c + 2 * 4 * c * c + 2 * c * c + 3 * c * 8)
    assert cc.flops == products + 3 * 2 * k * n * c
    assert cc.kernel_flops == 3 * 2 * k * n * c
