"""The port's FaCodec training path and voice-conversion variants against
the JAX package's (``flamed_tts_tpu/models/facodec/extras.py``) on the CPU
in fp32, with small widths and the random draws passed in explicitly: the
kernels' autograd route, gradient reversal, the predictor heads, the VQ
training path, the training decode, the redecoder and V2 conversion, and
the parameter trees carried across in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamed_tts_tpu.models.facodec import extras as jx
from flamed_tts_tpu.models.facodec.decoder import init_decoder_params
from flamed_tts_tpu.models.facodec.encoder import residual_unit_xla
from flamed_tts_tpu.models.facodec.timbre import init_timbre_params
from flamed_tts_tpu.ops.resample import snake_filtered_reference as j_snake

from flamed_tts_tpu_torch.convert import codec_tree, params_from_jax, params_to_jax
from flamed_tts_tpu_torch.models.facodec import extras
from flamed_tts_tpu_torch.models.facodec.decoder import init_decoder_params as init_decoder_params_t
from flamed_tts_tpu_torch.models.facodec.encoder import init_encoder_params as init_encoder_params_t
from flamed_tts_tpu_torch.ops import resunit, snake
from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree
from flamed_tts_tpu_torch.train_codec import leaves, tree_map

from torch_parity_utils import prompt_wav

D = 32  # codec width of these tests (the quantizers' and the timbre's)
UP = (2, 2, 2, 2)


def _port(tree, grad=False):
    """A JAX tree -> the port's tensors (requiring grad where asked)."""
    t = codec_tree(jax.device_get(tree))
    if grad:
        for leaf in leaves(t):
            leaf.requires_grad_()
    return t


def _grads_equal(torch_tree, torch_loss, jax_grads, atol, rtol):
    """Gradients of ``torch_loss`` w.r.t. every leaf of ``torch_tree``
    against the JAX gradient tree, path by path: within atol + rtol times
    the leaf's largest gradient (a parameter's gradient is a sum over every
    position, so fp32 summation order moves each element by a share of
    the leaf's scale, not of its own value)."""
    flat = leaves(torch_tree)
    grads = torch.autograd.grad(torch_loss, flat, allow_unused=True)
    got = {id(t): g if g is not None else torch.zeros_like(t) for t, g in zip(flat, grads)}
    ours = flatten_pytree(params_to_jax(tree_map(lambda t: got[id(t)], torch_tree)))
    ref = flatten_pytree(jax.device_get(jax_grads))
    assert ours.keys() == ref.keys()
    for k in ref:
        scale = float(np.abs(ref[k]).max()) if ref[k].size else 0.0
        np.testing.assert_allclose(ours[k], ref[k], atol=atol + rtol * scale, rtol=0, err_msg=k)


def _init(fn, seed, *args, **kw):
    """Random parameters from the port's init function ``fn`` as a numpy
    tree, for both sides (``test_trees_cross_both_ways`` holds each such
    tree's structure to the JAX init's)."""
    return params_to_jax(fn(torch.Generator().manual_seed(seed), *args, **kw))


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax_counts(key, b, n_layers, quantizer_dropout):
    """The quantizer-dropout counts ``jx.rvq_train`` draws from ``key``."""
    r1, _ = jax.random.split(key)
    n_q = np.full((b,), n_layers + 1, np.int32)
    n_drop = int(b * quantizer_dropout)
    n_q[:n_drop] = np.asarray(jax.random.randint(r1, (b,), 1, n_layers + 1))[:n_drop]
    return torch.from_numpy(n_q)


# --- the kernels' autograd route ------------------------------------------

def _unit(rng, c):
    return {"act1": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
            "conv1": {"w": _rand(rng, c, c, 7, scale=0.05), "b": _rand(rng, c, scale=0.1)},
            "act2": {"alpha": _rand(rng, c, scale=0.3), "beta": _rand(rng, c, scale=0.3)},
            "conv2": {"w": _rand(rng, c, c, 1, scale=0.05), "b": _rand(rng, c, scale=0.1)}}


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel launches stood in for by their plain versions, so that the
    wrappers' autograd Functions run on the CPU."""
    monkeypatch.setattr(snake, "_launch", snake.snake_filtered_reference)
    monkeypatch.setattr(resunit, "_unit_launch",
                        lambda x, p, d, prepared=None: resunit.residual_unit_reference(x, p, d))
    monkeypatch.setattr(resunit, "_stack_launch",
                        lambda x, units, dilations=(1, 3, 9), prepared=None:
                        resunit.residual_stack_reference(x, units, dilations))


@pytest.mark.parametrize("kernel,d", [("snake_filtered", 0), ("residual_unit", 1), ("residual_unit", 2),
                                      ("residual_unit", 3), ("residual_unit", 9), ("residual_stack", 0)])
def test_kernel_backward_matches_jax_vjp(plain_launches, kernel, d):
    """Each Function's backward (the plain chain's VJP) against jax.vjp of
    the JAX plain chain, for the input and every parameter, on the same
    upstream gradient."""
    rng = np.random.RandomState(d)
    c, x = 32, _rand(rng, 2, 40, 32)
    g = _rand(rng, 2, 40, 32)
    if kernel == "snake_filtered":
        p = _unit(rng, c)["act1"]
        jfn = lambda x, p: j_snake(x, p["alpha"], p["beta"])  # noqa: E731
        tfn = lambda x, p: snake.snake_filtered_cuda(x, p["alpha"], p["beta"])  # noqa: E731
    elif kernel == "residual_unit":
        p = _unit(rng, c)
        jfn = lambda x, p: residual_unit_xla(x, p, d)  # noqa: E731
        tfn = lambda x, p: resunit.residual_unit_cuda(x, p, d)  # noqa: E731
    else:
        p = [_unit(rng, c) for _ in range(3)]

        def jfn(x, units):
            for u, dd in zip(units, (1, 3, 9)):
                x = residual_unit_xla(x, u, dd)
            return x

        tfn = lambda x, p: resunit.residual_stack_cuda(x, p)  # noqa: E731
    ref_out, vjp = jax.vjp(jax.jit(jfn), x, p)
    ref_gx, ref_gp = jax.jit(vjp)(g)
    xt, pt = torch.from_numpy(x).requires_grad_(), _port(p, grad=True)
    out = tfn(xt, pt)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5, rtol=1e-5)
    gx, = torch.autograd.grad(out, xt, torch.from_numpy(g), retain_graph=True)
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx), atol=1e-5, rtol=1e-5)
    _grads_equal(pt, (out * torch.from_numpy(g)).sum(), ref_gp, atol=1e-5, rtol=1e-5)


# --- gradient reversal and the predictor heads ----------------------------

def test_gradient_reversal():
    x = torch.tensor([1.0, -3.0], requires_grad=True)
    y = extras.gradient_reversal(x, 2.0)
    assert torch.equal(y.detach(), x.detach())
    g, = torch.autograd.grad((y ** 2).sum() / 2, x)
    ref = jax.grad(lambda v: jnp.sum(jx.gradient_reversal(v, 2.0) ** 2) / 2)(jnp.asarray([1.0, -3.0]))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref))
    np.testing.assert_allclose(g.numpy(), [-2.0, 6.0])


@pytest.mark.parametrize("global_pred", [False, True])
def test_cnn_predictor_matches_jax(global_pred):
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(  # non-trivial snakes and biases
        lambda a: a + _rand(rng, *a.shape, scale=0.1), _init(extras.init_cnn_predictor, 1, D, 3, 2))
    x = _rand(np.random.RandomState(0), 2, 20, D)

    def jloss(p, x):
        return sum(jnp.sum(jnp.sin(h)) for h in jx.cnn_predictor(x, p, global_pred))

    ref = jax.jit(lambda p, x: jx.cnn_predictor(x, p, global_pred))(params, x)
    pt = _port(params, grad=True)
    out = extras.cnn_predictor(torch.from_numpy(x), pt, global_pred)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == ((2, 3) if global_pred else (2, 20, 3))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    _grads_equal(pt, sum(torch.sin(h).sum() for h in out), jax.jit(jax.grad(jloss))(params, x),
                 atol=1e-5, rtol=1e-4)


# --- the VQ training path -------------------------------------------------

@pytest.fixture(scope="module")
def dec():
    """A small decoder: quantizers of width D, a timbre encoder, the
    synthesis stack at UP."""
    return _init(init_decoder_params_t, 4, D, 16, UP)


@pytest.mark.parametrize("normalized,center", [(False, False), (True, True)])
def test_fvq_train_matches_jax(dec, normalized, center):
    layer = dec["quantizers"][1][1]
    x = _rand(np.random.RandomState(1), 2, 20, D, scale=3.0)

    def jloss(p, x):
        z_q, _, loss = jx.fvq_train(x, p, normalized_losses=normalized, center=center)
        return jnp.sum(jnp.sin(z_q)) + loss.sum()

    z_ref, c_ref, l_ref = jax.jit(lambda p, x: jx.fvq_train(x, p, normalized_losses=normalized,
                                                             center=center))(layer, x)
    pt = _port(layer, grad=True)
    z_q, codes, loss = extras.fvq_train(torch.from_numpy(x), pt, normalized_losses=normalized,
                                        center=center)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(z_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(l_ref), atol=1e-5, rtol=1e-5)
    _grads_equal(pt, torch.sin(z_q).sum() + loss.sum(), jax.jit(jax.grad(jloss))(layer, x),
                 atol=1e-5, rtol=1e-4)


def test_whiten_sg_and_whitening_fold_match_jax():
    rng = np.random.RandomState(3)
    z = (_rand(rng, 2, 30, 8) @ _rand(rng, 8, 8)) + 2.0  # correlated, off centre
    ref = np.asarray(jax.jit(jx._whiten_sg)(z))
    out = extras._whiten_sg(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    flat = out.reshape(-1, 8)
    # the covariance floor (1e-3 of the mean eigenvalue) keeps it a little off the identity
    np.testing.assert_allclose(np.cov(flat.T, bias=True), np.eye(8), atol=5e-2)
    # a degenerate batch: the isotropic fallback or the floored iteration, finite either way
    flat_z = np.ones((1, 5, 8), np.float32)
    np.testing.assert_allclose(extras._whiten_sg(torch.from_numpy(flat_z)).numpy(),
                               np.asarray(jax.jit(jx._whiten_sg)(flat_z)), atol=1e-6)
    w_in, b_in = rng.randn(8, D), rng.randn(8)
    samples = rng.randn(200, D) @ w_in.T + b_in
    for a, b in zip(extras.whitening_fold(w_in, b_in, samples), jx.whitening_fold(w_in, b_in, samples)):
        np.testing.assert_array_equal(a, b)


def test_rvq_and_analyze_train_match_jax(dec):
    dec = {"quantizers": dec["quantizers"], "timbre_encoder": dec["timbre_encoder"]}
    latents = _rand(np.random.RandomState(5), 4, 12, D, scale=2.0)
    key = jax.random.PRNGKey(9)

    def jfwd(p, x):
        return jx.analyze_train(p, x, key, quantizer_dropout=0.5, normalized_losses=True, center=True)

    def jloss(p, x):
        outs, _, losses, buf, timbre = jfwd(p, x)
        return jnp.sum(jnp.sin(outs)) + losses.sum() + jnp.sum(jnp.cos(buf[1])) + jnp.sum(timbre ** 2)

    outs_r, codes_r, losses_r, buf_r, timbre_r = jax.jit(jfwd)(dec, latents)
    n_q = [_jax_counts(k, 4, n, 0.5) for k, n in zip(jax.random.split(key, 3), (1, 2, 3))]
    assert any(int(c.min()) <= n for c, n in zip(n_q, (1, 2, 3)))  # a layer dropped somewhere
    pt = _port(dec, grad=True)
    outs, codes, losses, buf, timbre = extras.analyze_train(pt, torch.from_numpy(latents), n_q,
                                                            normalized_losses=True, center=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    for a, b in [(outs, outs_r), (losses, losses_r), (timbre, timbre_r)] + list(zip(buf, buf_r)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    loss = torch.sin(outs).sum() + losses.sum() + torch.cos(buf[1]).sum() + (timbre ** 2).sum()
    _grads_equal(pt, loss, jax.jit(jax.grad(jloss))(dec, latents), atol=1e-5, rtol=1e-4)
    # rvq_train alone, every layer kept
    q, c, l, per = extras.rvq_train(torch.from_numpy(latents), _port(dec["quantizers"][2]))
    q_r, c_r, l_r, per_r = jax.jit(lambda p, x: jx.rvq_train(x, p))(dec["quantizers"][2], latents)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
    for a, b in ((q, q_r), (l, l_r), (per, per_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_quantizer_counts_layout():
    n_q = extras.quantizer_counts(8, 3, 0.25, torch.Generator().manual_seed(0))
    assert n_q.dtype == torch.int32 and n_q.shape == (8,)
    assert ((n_q[:2] >= 1) & (n_q[:2] <= 3)).all() and (n_q[2:] == 4).all()
    assert (extras.quantizer_counts(8, 3, 0.0) == 4).all()


# --- the training decode, the redecoder, V2 -------------------------------

def test_decoder_training_forward_matches_jax(dec):
    heads = _init(extras.init_decoder_training_heads, 7, D, 7, 5, True, True, True)
    rng = np.random.RandomState(8)
    quantized = [_rand(rng, 3, 6, D) for _ in range(3)]
    spk = _rand(rng, 3, D, scale=0.5)
    key = jax.random.PRNGKey(3)
    flags = dict(use_gr_residual_f0=True, use_gr_residual_phone=True, use_gr_x_timbre=True,
                 up_ratios=UP)

    def jfwd(q):
        return jx.decoder_training_forward(dec, heads, q, spk, key, **flags)

    def jloss(q):
        out = jfwd(q)
        return sum(jnp.sum(jnp.sin(v)) for v in out.values())

    ref = jax.jit(jfwd)(quantized)
    draw = torch.from_numpy(np.array(jax.random.uniform(key, (3, 1, 1)))).reshape(3)
    qt = [torch.from_numpy(q).requires_grad_() for q in quantized]
    out = extras.decoder_training_forward(_port(dec), _port(heads), qt, torch.from_numpy(spk),
                                          residual_draw=draw, **flags)
    assert out.keys() == ref.keys()
    assert out["audio"].shape == (3, 6 * 16, 1) and out["x_timbre"].shape == (3, 5)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    got = torch.autograd.grad(sum(torch.sin(v).sum() for v in out.values()), qt)
    for a, b in zip(got, jax.jit(jax.grad(jloss))(quantized)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3)


def test_gradient_reversal_reaches_the_residual_group_negated():
    """A probe's gradient reaches the quantized input it reads negated."""
    heads = extras.init_decoder_training_heads(torch.Generator().manual_seed(0), in_channels=D,
                                               phone_classes=3, use_gr_residual_phone=True)
    q = torch.randn(1, 5, D, requires_grad=True)
    probe = extras.cnn_predictor(q, heads["res_phone_predictor"])[0].sum()
    reversed_probe = extras.cnn_predictor(extras.gradient_reversal(q), heads["res_phone_predictor"])[0].sum()
    g, = torch.autograd.grad(probe, q)
    g_rev, = torch.autograd.grad(reversed_probe, q)
    torch.testing.assert_close(g_rev, -g, atol=0.0, rtol=0.0)


def test_redecoder_forward_matches_jax():
    params = _init(extras.init_redecoder_params, 10, D, 16, UP, codebook_sizes=(5, 5, 5))
    params = jax.tree_util.tree_map(lambda a: a * 1e4 if a.shape == (5, D) else a, params)
    rng = np.random.RandomState(11)
    codes = rng.randint(0, 5, (6, 2, 7)).astype(np.int32)
    spk = _rand(rng, 2, D, scale=0.5)
    for residual in (False, True):
        ref = jax.jit(lambda p, c, s: jx.redecoder_forward(p, c, s, residual, UP))(params, codes, spk)
        out = extras.redecoder_forward(_port(params), torch.from_numpy(codes), torch.from_numpy(spk),
                                       residual, UP)
        assert out.shape == (2, 7 * 16, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_v2_voice_conversion_matches_jax():
    enc = _init(init_encoder_params_t, 12, ngf=4, out_channels=D)
    dec = _init(extras.init_decoder_v2_params, 13, D, 16, UP)
    src = prompt_wav(0.5, seed=1)[None, :, None]
    tgt = prompt_wav(0.3, seed=2)[None, :, None] * 0.7

    def jfwd(e, d, s, t):
        wav = jx.v2_voice_conversion(e, d, s, t, dec_up_ratios=UP)
        lat = jx.encoder_v2_forward(e, s)
        codes, timbre = jx.decoder_v2_quantize(d, lat, jx.encoder_v2_prosody_feature(s[:, :, 0])[:, :, :40])
        return wav, codes, timbre

    ref, j_codes, j_timbre = jax.jit(jfwd)(enc, dec, src, tgt)
    et, dt = _port(enc), _port(dec)
    out = extras.v2_voice_conversion(et, dt, torch.from_numpy(src), torch.from_numpy(tgt),
                                     dec_up_ratios=UP)
    assert out.shape == (1, 40 * 16, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # the V2 analysis' codes exactly
    lat = extras.encoder_v2_forward(et, torch.from_numpy(src))
    feat = extras.encoder_v2_prosody_feature(torch.from_numpy(src[:, :, 0]))[:, :, :40]
    codes, timbre = extras.decoder_v2_quantize(dt, lat, feat)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(timbre.numpy(), np.asarray(j_timbre), atol=1e-4, rtol=1e-4)


# --- parameter trees carried across ----------------------------------------

def test_trees_cross_both_ways():
    """The heads, redecoder and V2 trees: the port's init functions give
    the JAX package's structure and shapes (jax.eval_shape of its init),
    and numpy -> port (params_from_jax / codec_tree) -> numpy
    (params_to_jax) returns the same arrays."""
    key = jax.random.PRNGKey(0)

    def v2_shape(k):
        tree = init_decoder_params(k, in_channels=D, upsample_initial_channel=16, up_ratios=UP)
        tree["melspec_linear"] = {"w": jnp.zeros((D, 20)), "b": jnp.zeros((D,))}
        tree["melspec_encoder"] = init_timbre_params(k, d_model=D)
        return tree

    pairs = {
        "heads": (lambda k: jx.init_decoder_training_heads(k, D, 7, 5, True, True, True),
                  _init(extras.init_decoder_training_heads, 0, D, 7, 5, True, True, True)),
        "redecoder": (lambda k: jx.init_redecoder_params(k, D, 16, UP, codebook_sizes=(5, 5, 5)),
                      _init(extras.init_redecoder_params, 0, D, 16, UP, codebook_sizes=(5, 5, 5))),
        "v2": (v2_shape, _init(extras.init_decoder_v2_params, 0, D, 16, UP)),
        "trainer heads": (None, {"phone_w": np.ones((D, 40), np.float32), "phone_b": np.zeros(40, np.float32),
                                 "spk_w": np.ones((D, 3), np.float32), "spk_b": np.zeros(3, np.float32)}),
    }
    for name, (jax_init, tree) in pairs.items():
        ref = flatten_pytree(tree)
        if jax_init is not None:
            shapes = {k: v.shape for k, v in flatten_pytree(jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, np.float32), jax.eval_shape(jax_init, key))).items()}
            assert {k: v.shape for k, v in ref.items()} == shapes, name
        back = flatten_pytree(params_to_jax(params_from_jax(tree)))
        assert back.keys() == ref.keys(), name
        for k in ref:
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k], ref[k], err_msg=f"{name} {k}")
