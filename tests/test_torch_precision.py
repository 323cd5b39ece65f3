"""The matmul precision of the prior and the denoiser (``precision.py``),
at small widths on the CPU.

* ``"default"`` on CPU tensors, and ``"highest"`` anywhere, are float32: a
  bfloat16-stored model computes bit for bit what the same values in
  float32 storage compute (what the port computed before the weights were
  stored in bfloat16), and each layer what ``torch.nn``'s computes.
* The card's ``"default"`` arithmetic (bfloat16 operands, float32 sums),
  forced onto CPU tensors by ``precision.bf16_on_cpu``, holds to the JAX
  package's float32 run: the denoiser's latents after 8 Euler steps within
  the 0.05 relative bound of tests/test_bf16_quality.py, and the PVA's
  flow states (log(duration + 1)) within FLOW_TOL.
* ``cast_inference_params`` stores the prior and the prob in bfloat16, and
  a cast model goes through save -> ``from_pretrained`` -> sample.

The card's side is tests/test_torch_precision_cuda.py.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.prob.prob_generator import prob_sample as j_prob_sample
from flamed_tts_tpu.ops.masking import mask_from_lengths as j_mask

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.models.prior.sampling import pva_flow
from flamed_tts_tpu_torch.models.prob.prob_generator import prob_sample
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz

from torch_parity_utils import jax_params, small_config

# The PVA's flow states after 8 steps, bf16 operands against float32: an
# operand rounding is 2^-9 relative, and a field is three products deep
# (proj, two k3 convs, the head; the time MLP's two), so a velocity carries
# ~2-3 % of relative noise at worst; its sum over the steps moves a state
# of size ~0.1-2 by 0.02 at most.  0.05 leaves room without admitting a
# float32 path (the test also asserts the two runs differ).
FLOW_TOL = 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=2)
    return cfg, jmodel, params


def _rounded(params):
    """The parameters rounded to bfloat16 in float32 storage."""
    return {k: {n: v.to(torch.bfloat16).float() for n, v in sd.items()} for k, sd in params.items()}


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    phonemes = rng.randint(1, 300, (2, 12))
    prompts, timbres = rng.randint(0, 1024, (2, 6, 20)), rng.randn(2, 256).astype(np.float32)
    noise = {"dur": rng.randn(2, 16).astype(np.float32), "sil": rng.randn(2, 16).astype(np.float32)}
    # the latents' noise from a generator seeded 0, at the bucket the durations pick
    return dict(phonemes=phonemes, src_lens=np.array([12, 9]), prompts=prompts, timbres=timbres,
                nsteps_durgen=3, nsteps_denoiser=3, noise=noise, seed=0, fused=False)


def _sample(model, batch):
    out = model.sample_batch(**batch)
    return {k: np.asarray(out[k]) for k in ("latents", "prior_logits", "tgt_len", "tgt_mask")}


def _assert_same(a, b):
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_cpu_and_highest_are_float32_bit_for_bit(setup):
    """A cast model (bf16 storage) and one holding the same values in
    float32 storage give the same bits at "default" on the CPU and at
    "highest"; so does an uncast model at either precision."""
    cfg, _, params = setup
    batch = _batch()
    cast = Flamed(cfg, params, device="cpu")
    cast.cast_inference_params()
    stored32 = Flamed(cfg, _rounded(params), device="cpu")
    plain = Flamed(cfg, params, device="cpu")
    runs = {}
    for name in precision.PRECISIONS:
        with precision.matmul_precision(name):
            runs[name] = [_sample(m, batch) for m in (cast, stored32, plain)]
    for name in precision.PRECISIONS:
        _assert_same(runs[name][0], runs[name][1])
        _assert_same(runs[name][0], runs["default"][0])
        _assert_same(runs[name][2], runs["default"][2])
    assert not np.array_equal(runs["default"][0]["latents"], runs["default"][2]["latents"])


def test_layers_at_highest_are_torch_nn():
    """Each layer of precision.py against torch.nn's own forward, at
    "highest" (bf16_on_cpu changes nothing there) and at "default" on the
    CPU, bit for bit."""
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 12, generator=rng)
    pairs = []
    for ours, theirs in ((precision.Linear(12, 5), torch.nn.Linear(12, 5)),
                         (precision.LayerNorm(12, eps=1e-5), torch.nn.LayerNorm(12, eps=1e-5)),
                         (precision.Conv1d(12, 5, 3, padding=1), torch.nn.Conv1d(12, 5, 3, padding=1))):
        with torch.no_grad():
            for p in theirs.parameters():
                p.copy_(torch.randn(p.shape, generator=rng))
        ours.load_state_dict(theirs.state_dict())
        pairs.append((ours, theirs, x.transpose(1, 2) if isinstance(ours, torch.nn.Conv1d) else x))
    emb = precision.Embedding(9, 4)
    ids = torch.tensor([[1, 8, 0]])
    b = torch.randn(2, 12, 3, generator=rng)
    for name, forced in (("highest", True), ("highest", False), ("default", False)):
        with precision.matmul_precision(name):
            ctx = precision.bf16_on_cpu() if forced else torch.no_grad()
            with ctx, torch.no_grad():
                for ours, theirs, inp in pairs:
                    assert torch.equal(ours(inp), theirs(inp)), type(ours).__name__
                assert torch.equal(precision.matmul(x, b), x @ b)
                assert torch.equal(emb(ids), F.embedding(ids, emb.weight))


def test_default_on_cpu_widens_bf16_parameters():
    """bf16 parameters against float32 inputs: float32 results equal to the
    layers with the widened parameters."""
    rng = torch.Generator().manual_seed(1)
    x = torch.randn(3, 12, generator=rng)
    lin, ln = precision.Linear(12, 5), precision.LayerNorm(12)
    with torch.no_grad():
        ln.weight.copy_(torch.randn(12, generator=rng))
    with torch.no_grad():
        ref_lin = F.linear(x, lin.weight.bfloat16().float(), lin.bias.bfloat16().float())
        ref_ln = F.layer_norm(x, (12,), ln.weight.bfloat16().float(), ln.bias.bfloat16().float())
    for m in (lin, ln):
        m.to(torch.bfloat16)
    emb = precision.Embedding(5, 3).to(torch.bfloat16)
    with torch.no_grad():
        assert lin(x).dtype == ln(x).dtype == emb(torch.tensor([1])).dtype == torch.float32
        assert torch.equal(lin(x), ref_lin) and torch.equal(ln(x), ref_ln)
        # a small parameter's widened copy is kept until the parameter changes
        w = precision.widen(ln.weight, x)
        assert precision.widen(ln.weight, x) is w and torch.equal(w, ln.weight.float())
        ln.weight.add_(1.0)
        assert not torch.equal(precision.widen(ln.weight, x), w)
        assert torch.equal(precision.widen(ln.weight, x), ln.weight.float())
    widened = precision.widen(ln.weight.requires_grad_(), x)
    assert widened.grad_fn is not None  # under grad: a cast autograd sees, never the kept copy


def test_bf16_operands_hold_the_denoiser_to_jax_float32(setup):
    """The denoiser's 8 Euler steps with bf16 operands (forced on the CPU)
    against the JAX package's float32 run on the same bf16-stored weights
    and noise: relative latent error under 0.05 (tests/test_bf16_quality.py's
    bound), and not float32's (the runs differ)."""
    cfg, jmodel, params = setup
    rng = np.random.RandomState(6)
    hiddens = rng.randn(1, 6, 24, cfg["prob_generator"]["cond_dim"]).astype(np.float32)
    spk = rng.randn(1, 256).astype(np.float32)
    lens = np.array([20], np.int32)
    key = jax.random.PRNGKey(7)
    jmodel.cast_inference_params()
    try:
        ref = np.asarray(j_prob_sample(jmodel.prob_module, jmodel.params["prob"], jnp.asarray(hiddens),
                                       jnp.asarray(spk), j_mask(jnp.asarray(lens), 24), key, 8, 0.3))
    finally:
        jmodel.params = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.params)
    noise = _t(jax.random.normal(key, (1, 24, 256)))
    model = Flamed(cfg, params, device="cpu")
    model.cast_inference_params()
    args = (model.prob, _t(hiddens), _t(spk), mask_from_lengths(_t(lens).long(), 24), noise, 8, 0.3)
    lat32 = prob_sample(*args).numpy()
    np.testing.assert_allclose(lat32, ref, atol=1e-4, rtol=1e-4)
    with precision.matmul_precision("default"), precision.bf16_on_cpu():
        lat16 = prob_sample(*args).numpy()
    valid = slice(0, int(lens[0]))
    rel = float(np.linalg.norm(lat16[:, valid] - ref[:, valid]) / np.linalg.norm(ref[:, valid]))
    assert 0 < rel < 0.05, rel


def test_bf16_operands_hold_the_pva_flow_to_jax_float32(setup):
    """The PVA's flow states after 8 steps with bf16 operands (forced on the
    CPU) against the JAX package's float32 Euler loop over its pva_fields,
    same bf16-stored weights and noise: max abs difference under FLOW_TOL."""
    cfg, jmodel, params = setup
    model = Flamed(cfg, params, device="cpu")
    model.cast_inference_params()
    rng = np.random.RandomState(8)
    phonemes = rng.randint(1, 300, (2, 16))
    lens = np.array([16, 11])
    phonemes[1, 11:] = 0
    noise = rng.randn(2, 2, 16).astype(np.float32)
    src_mask = mask_from_lengths(_t(lens), 16)
    enc = model.prior.encode(_t(phonemes), src_mask)

    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jmodel.params["prior"])
    j_enc, j_mask16 = jnp.asarray(enc.detach().numpy()), jnp.asarray(src_mask.numpy())
    dur, sil = jnp.asarray(noise[0]) * 0.3, jnp.asarray(noise[1]) * 0.3
    for t in np.linspace(0.0, 1.0, 9, dtype=np.float32)[:-1]:
        v_dur, v_sil = jmodel.prior_module.apply(jp, dur, sil, j_enc, jnp.float32(t), j_mask16,
                                                 method="pva_fields")
        dur, sil = dur + v_dur / 8, sil + v_sil / 8
    ref = np.stack([np.asarray(dur), np.asarray(sil)])

    args = (model.prior, enc, src_mask, _t(noise[0]), _t(noise[1]), 8, 0.3)
    flow32 = np.stack([t.numpy() for t in pva_flow(*args)])
    np.testing.assert_allclose(flow32, ref, atol=1e-4, rtol=1e-4)
    with precision.matmul_precision("default"), precision.bf16_on_cpu():
        flow16 = np.stack([t.numpy() for t in pva_flow(*args)])
    err = float(np.abs(flow16 - ref).max())
    assert 0 < err < FLOW_TOL, err


def test_cast_model_storage_and_round_trip(setup, tmp_path):
    """cast_inference_params stores every float parameter of the prior and
    the prob in bf16 (half the bytes); the cast model saved as the JAX
    package's .npz, read by from_pretrained and cast again samples what the
    cast model samples, bit for bit."""
    cfg, _, params = setup
    model = Flamed(cfg, params, device="cpu")
    n_bytes = sum(p.numel() * p.element_size() for m in (model.prior, model.prob) for p in m.parameters())
    model.cast_inference_params()
    for m in (model.prior, model.prob):
        assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert 2 * sum(p.numel() * p.element_size()
                   for m in (model.prior, model.prob) for p in m.parameters()) == n_bytes
    path = str(tmp_path / "cast.npz")
    save_pytree_npz(path, {k: params_to_jax(getattr(model, k).state_dict()) for k in ("prior", "prob")})
    again = Flamed.from_pretrained(cfg, path, device="cpu")
    again.cast_inference_params()
    for k in ("prior", "prob"):
        for (n, a), b in zip(getattr(model, k).state_dict().items(), getattr(again, k).state_dict().values()):
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), n
    batch = _batch(4)
    _assert_same(_sample(model, batch), _sample(again, batch))


def test_tensor_parallel_forward_takes_bf16_parameters(setup):
    """The denoiser's split forward (parallel/tensor_parallel.py) over a
    model group of one, with the parameters stored in bf16, against the
    plain forward."""
    cfg, _, params = setup
    model = Flamed(cfg, params, device="cpu")
    model.cast_inference_params()
    den = model.prob.denoiser
    rng = np.random.RandomState(9)
    x = _t(rng.randn(2, 24, 256).astype(np.float32))
    mods = [m[0] for m in den.compute_mods(torch.tensor([0.25]), _t(rng.randn(2, 256).astype(np.float32)))]
    mask = mask_from_lengths(torch.tensor([24, 17]), 24)
    with torch.no_grad():
        ref = den(x, mods, mask)
        den.tp = types.SimpleNamespace(size=1, rank=0, group=None)
        try:
            out = den(x, mods, mask)
        finally:
            den.tp = None
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_forced_backward_rounds_operands_not_results():
    """Under grad with bf16 operands (forced on the CPU, the card's code):
    a Linear's, a k3 conv's and a batched product's gradients are the
    products of the bf16-rounded incoming gradient and the bf16-rounded
    saved operands, summed without rounding (float64 reference, 1e-5 of
    each tensor's peak); the gradient a conv returns to its input is summed
    over the windows unrounded.  float32 gradients are off by far more."""
    gen = torch.Generator().manual_seed(5)
    r = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    lin, conv = precision.Linear(40, 24), precision.Conv1d(40, 16, 3, padding=1)
    x = torch.randn(2, 30, 40, generator=gen, requires_grad=True)
    a = torch.randn(2, 3, 30, 8, generator=gen, requires_grad=True)
    b = torch.randn(2, 3, 8, 30, generator=gen, requires_grad=True)
    cl, cc, cm = (torch.randn(2, 30, 24, generator=gen), torch.randn(2, 16, 30, generator=gen),
                  torch.randn(2, 3, 30, 30, generator=gen))
    with precision.matmul_precision("default"), precision.bf16_on_cpu():
        outs = (lin(x), conv(x.transpose(1, 2)), precision.matmul(a, b))
        sum((o * c).sum() for o, c in zip(outs, (cl, cc, cm))).backward()
    xd, w, wc = x.detach().double(), lin.weight.detach(), conv.weight.detach()
    xp = F.pad(r(xd), (0, 0, 1, 1))                                   # (2, 32, 40)
    ccl = cc.transpose(1, 2)                                           # (2, 30, 16)
    gxc = torch.zeros_like(xp)
    for j in range(3):
        gxc[:, j:j + 30] += r(ccl) @ r(wc[:, :, j])
    want = {
        "x": r(cl) @ r(w) + gxc[:, 1:31],
        "lin.weight": torch.einsum("blo,bli->oi", r(cl), r(xd)),
        "conv.weight": torch.stack([torch.einsum("blo,bli->oi", r(ccl), xp[:, j:j + 30])
                                    for j in range(3)], -1),
        "a": r(cm) @ r(b.detach()).transpose(-1, -2),
        "b": r(a.detach()).transpose(-1, -2) @ r(cm),
    }
    got = {"x": x.grad, "lin.weight": lin.weight.grad, "conv.weight": conv.weight.grad,
           "a": a.grad, "b": b.grad}
    plain = {"x": cl @ w + F.conv_transpose1d(cc, wc, padding=1).transpose(1, 2),
             "lin.weight": torch.einsum("blo,bli->oi", cl, x.detach())}
    for k, g in got.items():
        assert g.dtype == torch.float32, k
        peak = float(want[k].abs().max())
        assert float((g.double() - want[k]).abs().max()) < 1e-5 * peak, k
        if k in plain:
            assert float((plain[k].double() - want[k]).abs().max()) > 1e-3 * peak, k
