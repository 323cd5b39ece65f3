"""The denoiser's kernels (csrc/denoiser.cu, ``ops/denoiser.py``) on the card
against their plain versions, alone and as whole blocks and samplers, at
the serving width C = 1024.  Needs a card (``cuda`` marker); imports
nothing of JAX:

    python -m pytest tests/test_torch_denoiser_cuda.py -q -m cuda

The plain chain runs on the card too: ``plain_on_card`` routes every piece
to its ``*_reference`` version, so both sides take the same products.
Tolerances (fp32, TF32 off), each from the order of a sum, the only
freedom the kernels take:
* ``s``, the residual sum: the same adds and products in the same order,
  exact.
* LayerNorm outputs: mean and variance are sums of 1024 values in another
  order (a few units in the last place of the sums), which moves a
  normalized value by ~1e-6 of its size: 1e-5 absolute and relative.
* conv_norm: 31-tap sums in another order, and the norm's sums over up to
  1408 frames: 1e-5 absolute and relative on values of about 1.
* GELU / SiLU: one erff or expf each (2 ulp): 1e-6 relative.
* bf16 operands: both sides round the same fp32 value to bf16 where it is
  the same; where the sums above move it across a rounding boundary it is
  one bf16 step away: at most 1 step, 2^-7 of max(|value|, mean |value|).
* a block or the final layer: the pieces' differences through the
  products at C = 1024: relative L2 below 1e-5, each value within 1e-4 of
  the largest.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops import denoiser
from flamed_tts_tpu_torch.ops.convnext import AdaLNResBlock, FinalLayer, Residual
from flamed_tts_tpu_torch.precision import matmul_precision

pytestmark = pytest.mark.cuda

C = 1024
TOL = dict(atol=1e-5, rtol=1e-5)
ACT_TOL = dict(atol=1e-6, rtol=1e-6)
CASES = [(1, 768, "none"), (1, 256, "one"), (4, 1408, "pad44"), (4, 333, "pad44"),
         (1, 1408, "none"), (4, 768, "one"), (1, 333, "pad44"), (4, 256, "none")]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build(["denoiser"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def plain_on_card():
    """The pieces' plain versions for CUDA tensors too."""
    saved = denoiser.norm_modulate_cuda, denoiser.conv_norm_cuda, denoiser.activation_cuda
    denoiser.norm_modulate_cuda = lambda *a: denoiser.norm_modulate_reference(*a[:13])
    denoiser.conv_norm_cuda = denoiser.conv_norm_reference
    denoiser.activation_cuda = denoiser.activation_reference
    try:
        yield
    finally:
        denoiser.norm_modulate_cuda, denoiser.conv_norm_cuda, denoiser.activation_cuda = saved


def _mask(b, t, kind, dev):
    """(B, T) True = pad: no padding; 44 % of frames padded (the first row
    whole, the others 56 % long); one valid frame a row."""
    lens = {"none": [t] * b, "one": [1] * b,
            "pad44": [t] + [max(1, round(0.56 * t)) - i for i in range(b - 1)]}[kind]
    return torch.arange(t, device=dev)[None, :] >= torch.tensor(lens, device=dev)[:, None]


def _rand(rng, *shape, scale=1.0, dev="cuda"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _bf16_steps(out, ref):
    """Largest difference in bf16 steps: 2^-7 of max(|ref|, mean |ref|), so
    that a value near 0, whose fp32 error is of the row's scale, is not
    held to its own."""
    out, ref = out.float(), ref.float()
    step = 2.0 ** -7 * torch.maximum(ref.abs(), ref.abs().mean()).clamp_min(1e-30)
    return float(((out - ref).abs() / step).max())


@pytest.mark.parametrize("b,t,mask_kind", CASES)
@pytest.mark.parametrize("variant", ["x", "first", "residual", "residual_no_bias", "mlp_in", "final",
                                     "final_windows"])
def test_norm_modulate_kernel(dev, b, t, mask_kind, variant):
    """Each mode of the kernel: a norm of x alone; the first block's norm
    adding proj_in's bias; a block's first norm adding the previous block's
    residual gate * (h + bias), and one without bias or affine; the MLP's
    norm adding gate * (u + (y + bias)) and writing a bf16 operand; the
    final layer's masked norm without affine, and the same written as the
    k3 windows of the conv after it."""
    rng = np.random.RandomState(b * t)
    x, r1, r2 = (_rand(rng, b, t, C) for _ in range(3))
    mods = _rand(rng, b, 1, 3 * C, scale=0.5)
    shift, scale, gate = mods.chunk(3, dim=-1)
    w, bias, rb = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    mask = _mask(b, t, mask_kind, dev)
    final = (x, gate, r1, r2, rb, shift, scale, None, None, mask, 1e-6, True)
    args = {"x": (x, None, None, None, None, shift, scale, w, bias, None, 1e-6, False),
            "first": (x, None, None, None, rb, shift, scale, w, bias, None, 1e-6, False),
            "residual": (x, gate, r1, None, rb, shift, scale, w, bias, None, 1e-6, False),
            "residual_no_bias": (x, gate, r1, None, None, shift, scale, None, None, None, 1e-6, False),
            "mlp_in": (x, gate, r1, r2, rb, shift, scale, w, bias, None, 1e-6, True),
            "final": final, "final_windows": final + (True,)}[variant]
    with torch.no_grad():
        s, out = denoiser.norm_modulate_cuda(*args)
        s_ref, ref = denoiser.norm_modulate_reference(*args)
    assert torch.equal(s, s_ref)
    if args[11]:  # a bf16 operand
        assert out.dtype == torch.bfloat16 and _bf16_steps(out, ref) <= 1.0
        with matmul_precision("highest"), torch.no_grad():
            out, ref = denoiser.norm_modulate_cuda(*args)[1], denoiser.norm_modulate_reference(*args)[1]
    torch.testing.assert_close(out, ref, **TOL)
    if variant == "final":
        assert not out[mask].any()


@pytest.mark.parametrize("b,t,mask_kind", CASES)
def test_conv_norm_kernel(dev, b, t, mask_kind):
    rng = np.random.RandomState(b + t)
    x = _rand(rng, b, t, C)
    cw, cb = _rand(rng, C, 1, 31, scale=1 / math.sqrt(31)), _rand(rng, C, scale=0.1)
    w, bias = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    mask = _mask(b, t, mask_kind, dev)
    with torch.no_grad():
        out = denoiser.conv_norm_cuda(x, cw, cb, w, bias, mask, 1e-5)
        ref = denoiser.conv_norm_reference(x, cw, cb, w, bias, mask, 1e-5, False)
        torch.testing.assert_close(out, ref, **TOL)
        assert not out[mask].any()
        op = denoiser.conv_norm_cuda(x, cw, cb, w, bias, mask, 1e-5, True)
    assert op.dtype == torch.bfloat16 and _bf16_steps(op, ref.bfloat16()) <= 1.0


@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_activation_kernel(dev, kind):
    rng = np.random.RandomState(7)
    y, bias = _rand(rng, 4, 1408, C, scale=3.0), _rand(rng, C)
    with torch.no_grad():
        out = denoiser.activation_cuda(y, bias, kind)
        ref = denoiser.activation_reference(y, bias, kind, False)
        torch.testing.assert_close(out, ref, **ACT_TOL)
        op = denoiser.activation_cuda(y, bias, kind, True)
    assert op.dtype == torch.bfloat16 and _bf16_steps(op, ref.bfloat16()) <= 1.0


def _randomize(module, seed):
    """Default-initialised products and taps; the norms' and biases'
    vectors drawn from a seed, so that no affine parameter is the identity."""
    torch.manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                base = 1.0 if ("ln" in name and name.endswith("weight")) else 0.0
                p.copy_(base + torch.from_numpy((rng.randn(*p.shape) * 0.1).astype(np.float32)))
    return module


def _close(out, ref, rel_l2=1e-5, max_rel=1e-4):
    err = float((out.double() - ref.double()).norm() / ref.double().norm())
    worst = float((out - ref).abs().max() / ref.abs().max())
    assert err <= rel_l2 and worst <= max_rel, (err, worst)


@pytest.mark.parametrize("b,t,mask_kind", CASES[:4])
def test_block_and_final_layer_steps(dev, b, t, mask_kind):
    """One AdaLNResBlock (its input the previous block's Residual) and one
    FinalLayer through the kernels against the plain chain, in fp32."""
    rng = np.random.RandomState(t)
    blk = _randomize(AdaLNResBlock(C), 1).to(dev)
    fin = _randomize(FinalLayer(C, 256), 2).to(dev)
    mask = _mask(b, t, mask_kind, dev)
    prev = Residual(_rand(rng, b, t, C), _rand(rng, b, t, C), _rand(rng, b, 1, C, scale=0.5))
    m_blk, m_fin = _rand(rng, b, 1, 6 * C, scale=0.5), _rand(rng, b, 1, 5 * C, scale=0.5)
    with matmul_precision("highest"), torch.no_grad():
        got = blk(prev, m_blk, mask)
        out = fin(got, m_fin, mask)
        with plain_on_card():
            want = blk(prev, m_blk, mask)
            ref = fin(want, m_fin, mask)
    for a, r in ((got.x, want.x), (got.h, want.h), (got.value(), want.value()), (out, ref)):
        _close(a, r)


def _prob(dev, seed=0):
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator

    cfg = load_default_config()["prob_generator"]
    torch.manual_seed(seed)
    prob = ProbGenerator(cfg).to(dev).eval()
    for p in prob.parameters():  # stored as served (Flamed.cast_inference_params)
        p.data = p.data.to(torch.bfloat16)
    return prob, cfg


def test_prob_sample_matches_the_plain_chain(dev):
    """``prob_sample`` at nfe 64 in serving precision (bf16 weights and
    operands) at B = 2, bucket 768, the second row 44 % padding: the
    latents on the valid frames within 0.02 relative L2 of the plain
    chain's."""
    from flamed_tts_tpu_torch.models.prob.prob_generator import prob_sample

    prob, cfg = _prob(dev)
    rng = np.random.RandomState(3)
    b, t = 2, 768
    mask = _mask(b, t, "pad44", dev)
    hid = _rand(rng, b, cfg["n_quantizers"], t, cfg["cond_dim"])
    spk, noise = _rand(rng, b, cfg["spk_dim"]), _rand(rng, b, t, cfg["target_dim"])
    n = cfg["n_layers"]
    kernels.reset_launches()
    got = prob_sample(prob, hid, spk, mask, noise, 64, 0.3)
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), "norm_modulate": 64 * (2 * n + 2),
                                "conv_norm": 64 * (n + 1), "act": 64 * (2 * n + 1)}
    with plain_on_card():
        ref = prob_sample(prob, hid, spk, mask, noise, 64, 0.3)
    valid = ~mask
    err = float((got[valid] - ref[valid]).double().norm() / ref[valid].double().norm())
    print(f"[prob_sample] latents rel L2 on the valid frames: {err:.3e}")
    assert torch.isfinite(got).all() and err <= 0.02


def _step_inputs(dev, b=1, t=768):
    prob, cfg = _prob(dev)
    rng = np.random.RandomState(4)
    den = prob.denoiser
    ts = torch.linspace(0.0, 1.0, 65, device=dev)[:-1]
    with torch.no_grad():
        mods = [m[10] for m in den.compute_mods(ts, _rand(rng, b, cfg["spk_dim"]))]
    x = _rand(rng, b, t, cfg["target_dim"])
    return den, x, mods, _mask(b, t, "none", dev)


def test_captured_step_equals_the_eager_step(dev):
    """One denoiser step captured as a CUDA graph: its first replay and a
    later one equal the eager call bit for bit; the capture counts the
    hand launches, the replays launch nothing more from the host."""
    den, x, mods, mask = _step_inputs(dev)
    with torch.no_grad():
        eager = den(x, mods, mask)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            den(x, mods, mask)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launches()
        with torch.cuda.graph(graph):
            static = den(x, mods, mask)
        captured = dict(kernels.launches)
        graph.replay()
        first = static.clone()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    n = len(den.blocks())
    assert captured == {**dict.fromkeys(captured, 0), "norm_modulate": 2 * n + 2, "conv_norm": n + 1,
                        "act": 2 * n + 1} and kernels.launches == captured
    assert torch.equal(first, eager) and torch.equal(static, eager)


def test_eager_step_launches_few_kernels(dev):
    """One eager step at B = 1, bucket 768 in serving precision: at most 60
    device kernels, the hand kernels among them, and no
    ``conv_depthwise2d_forward`` (PyTorch's native depthwise conv)."""
    den, x, mods, mask = _step_inputs(dev)
    with torch.no_grad():
        for _ in range(2):
            den(x, mods, mask)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            den(x, mods, mask)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {}
    for n in names:
        counts[n[:90]] = counts.get(n[:90], 0) + 1
    print(f"[step] {len(names)} device operations: " + "; ".join(f"{v} x {k}" for k, v in counts.items()))
    hand = sum(any(k in n for k in ("norm_modulate_kernel", "conv_norm_kernel", "act_kernel"))
               for n in names)
    assert hand == 5 * len(den.blocks()) + 4
    assert len(names) <= 60 and not any("conv_depthwise2d" in n for n in names)
