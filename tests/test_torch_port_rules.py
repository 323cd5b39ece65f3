"""Rules of the PyTorch/CUDA port: it imports no JAX and nothing of the JAX
package, and it never drops to the CPU or to a kernel's plain version on
its own."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flamed_tts_tpu_torch
from flamed_tts_tpu_torch import kernels

PKG_DIR = os.path.dirname(flamed_tts_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flamed_tts_tpu'] = None\n"
        "import flamed_tts_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'flamed_tts_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k])\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules = len(list(pkgutil.walk_packages([PKG_DIR], "flamed_tts_tpu_torch.")))
    assert int(res.stdout.split()[-1]) == n_modules >= 65


def test_no_reference_to_jax_package():
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            for needle in ("flamed_tts_tpu.", "import jax", "from jax"):
                if needle in text:
                    offenders.append(f"{os.path.relpath(path, ROOT)}: {needle}")
    assert not offenders, offenders


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.models.flamed import Flamed

    cfg = load_default_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Flamed(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaCodec.from_pretrained(os.path.join(ROOT, "artifacts", "codec_r5"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaCodec.random_init(torch.Generator().manual_seed(0))


ENTRY_POINT_ARGS = {
    "evaluate": ["--synth-dir", "s", "--metadata-file", "m.txt", "--prompt-dir", "p", "--codec-dir", "random"],
    "dump_decoded": ["--corpus", "c", "--codec-dir", "random", "--out-dir", "o"],
    "train_asr": ["--corpus", "c", "--out", "o.npz"],
    "eval_discrimination": ["--corpus", "c"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINT_ARGS))
def test_evaluation_entry_points_refuse_to_run_without_a_card(name, tmp_path):
    """Each evaluation entry point asks for the card before it reads a
    file, and the recognizer does too, unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import importlib

    from flamed_tts_tpu_torch.asr import PhonemeRecognizer

    main = importlib.import_module(f"flamed_tts_tpu_torch.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a if a.startswith("--") or a == "random" else str(tmp_path / a)
              for a in ENTRY_POINT_ARGS[name]])
    with pytest.raises(FileNotFoundError):  # past the device check, to the missing input
        main([a if a.startswith("--") or a == "random" else str(tmp_path / a)
              for a in ENTRY_POINT_ARGS[name]] + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PhonemeRecognizer()
    assert PhonemeRecognizer(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from flamed_tts_tpu_torch.ops.resunit import residual_stack_cuda, residual_unit_cuda
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake_filtered_cuda(x, torch.zeros(32), torch.zeros(32))
    p = {"act1": {"alpha": torch.zeros(32), "beta": torch.zeros(32)},
         "act2": {"alpha": torch.zeros(32), "beta": torch.zeros(32)},
         "conv1": {"w": torch.zeros(32, 32, 7), "b": torch.zeros(32)},
         "conv2": {"w": torch.zeros(32, 32, 1), "b": torch.zeros(32)}}
    with pytest.raises(ValueError, match="CUDA tensor"):
        residual_unit_cuda(x, p, 1)
    # K2 takes multiples of 16 (16 mod 32 zero-padded for the launch); 24 it refuses
    with pytest.raises(ValueError, match="C % 16"):
        residual_unit_cuda(torch.zeros(1, 8, 24), p, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        residual_stack_cuda(x, [p, p, p])
    from flamed_tts_tpu_torch.ops import denoiser

    x, m, w = torch.zeros(1, 8, 128), torch.zeros(1, 1, 128), torch.ones(128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        denoiser.norm_modulate_cuda(x, m, x, x, w, m, m, w, w, None, 1e-6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        denoiser.conv_norm_cuda(x, torch.zeros(128, 1, 31), w, w, w, None, 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        denoiser.activation_cuda(x, w, "gelu")


def _denoiser_on_meta(monkeypatch, plain):
    """The denoiser's blocks on meta tensors: every piece goes to its
    kernel wrapper, which refuses the tensor before any launch."""
    from flamed_tts_tpu_torch.models.prob.prob_generator import SimpleMLPAdaLN
    from flamed_tts_tpu_torch.ops import denoiser

    for name in ("norm_modulate_reference", "conv_norm_reference", "activation_reference"):
        monkeypatch.setattr(denoiser, name, plain)
    den = SimpleMLPAdaLN(8, 128, 8, 16, 2).to("meta")
    x, mask = torch.zeros(1, 40, 8, device="meta"), torch.zeros(1, 40, dtype=torch.bool, device="meta")
    mods = den.mods_at(torch.zeros((), device="meta"), torch.zeros(1, 16, device="meta"))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        den(x, mods, mask)
    u, cm = torch.zeros(1, 40, 128, device="meta"), den.blocks()[0].conv_in
    with pytest.raises(ValueError, match="CUDA tensor"):
        cm(u, mask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        denoiser.activation(u, "silu")
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("route", [False, True, "denoiser"])
def test_off_cpu_tensors_never_reach_a_plain_version(monkeypatch, route):
    """A tensor that does not lie on the CPU goes to a kernel wrapper, which
    launches or raises: the dispatchers have no route from it to a plain
    version.  (A meta tensor stands for an off-CPU tensor on a host without
    a card.)  ``route``: the codec's, with K3 fused or not, or the
    denoiser's."""
    from flamed_tts_tpu_torch.ops import resunit, snake

    def plain(*args, **kwargs):
        raise AssertionError("a plain version was reached from an off-CPU tensor")

    if route == "denoiser":
        return _denoiser_on_meta(monkeypatch, plain)
    fuse = route
    for module, name in ((resunit, "residual_unit_reference"), (resunit, "residual_stack_reference"),
                         (resunit, "snake_filtered_reference"), (snake, "snake_filtered_reference")):
        monkeypatch.setattr(module, name, plain)
    c = 64
    x = torch.zeros(1, 300, c, device="meta")
    p = {"act1": {"alpha": torch.zeros(c), "beta": torch.zeros(c)},
         "act2": {"alpha": torch.zeros(c), "beta": torch.zeros(c)},
         "conv1": {"w": torch.zeros(c, c, 7), "b": torch.zeros(c)},
         "conv2": {"w": torch.zeros(c, c, 1), "b": torch.zeros(c)}}
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        resunit.residual_stack(x, [p, p, p], fuse=fuse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        resunit.residual_unit(x, p, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake.snake_filtered(x, torch.zeros(c), torch.zeros(c))
    assert not any(kernels.launches.values())


# The benchmark entry points' settings, read in their main() as the root
# scripts read them; nothing below them reads the environment.
BENCH_ENV = {"bench.py": ['os.environ.get("BENCH_PRECISION", "bf16")'],
             "bench_throughput.py": ['os.environ.get("BENCH_BATCH", "4")',
                                     'os.environ.get("BENCH_NFE", "128")']}


def test_no_environment_variable_decides_a_route():
    """Which kernel runs follows from the tensor (device, width, type) and
    the caller's ``fuse_blocks`` alone: the port reads no environment
    variable, but for the benchmark entry points' ``BENCH_*`` settings."""
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    text = f.read()
                if dirpath == PKG_DIR:
                    for allowed in BENCH_ENV.get(name, []):
                        assert allowed in text, (name, allowed)
                        text = text.replace(allowed, "")
                offenders += [f"{name}: {needle}" for needle in ("environ", "getenv") if needle in text]
    assert not offenders, offenders


def _denoiser_gradient(monkeypatch, piece):
    """``test_kernel_wrappers_carry_the_plain_chains_gradient`` for a piece
    of ``ops/denoiser.py``: every input and parameter, the modulations per
    frame as the trainer's ``mods_at`` makes them, a mask of padded frames."""
    from flamed_tts_tpu_torch.ops import denoiser

    def nm_launch(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps, out_dtype, keep,
                  windows):
        s, out = denoiser.norm_modulate_reference(x, gate, r1, r2, rb, shift, scale, weight, bias,
                                                  pad_mask, eps, False, windows)
        return (s if (r1 is not None or rb is not None) and keep else None), out

    monkeypatch.setattr(denoiser, "_norm_modulate_launch", nm_launch)
    monkeypatch.setattr(denoiser, "_conv_norm_launch",
                        lambda x, cw, cb, nw, nb, m, eps, dt: denoiser.conv_norm_reference(
                            x, cw, cb, nw, nb, m, eps, False))
    monkeypatch.setattr(denoiser, "_activation_launch",
                        lambda y, bias, kind, dt: denoiser.activation_reference(y, bias, kind, False))
    rng = np.random.RandomState(3)
    b, t, c = 2, 40, 16

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).requires_grad_()

    mask = torch.zeros(b, t, dtype=torch.bool)
    mask[1, 29:] = True
    x = rnd(b, t, c)
    mods = rnd(b, t, 3 * c, scale=0.3)
    shift, scale, gate = mods.chunk(3, dim=-1)
    if piece == "norm_modulate":
        r1, r2, rb, w, bias = rnd(b, t, c), rnd(b, t, c), rnd(c), rnd(c), rnd(c)
        args, n_out = (x, gate, r1, r2, rb, shift, scale, w, bias, mask, 1e-6), 2
        wrapper, plain = denoiser.norm_modulate_cuda, denoiser.norm_modulate_reference
        params = [r1, r2, rb, mods, w, bias]
    elif piece == "conv_norm":
        cw, cb, w, bias = rnd(c, 1, 31, scale=0.2), rnd(c), rnd(c), rnd(c)
        args, n_out = (x, cw, cb, w, bias, mask, 1e-5), 1
        wrapper, plain, params = denoiser.conv_norm_cuda, denoiser.conv_norm_reference, [cw, cb, w, bias]
    else:
        bias = rnd(c)
        args, n_out = (x, bias, "silu"), 1
        wrapper, plain, params = denoiser.activation_cuda, denoiser.activation_reference, [bias]
    # norm_modulate also with its k3 windows out (the final layer's)
    for extra in ([(False,), (False, True)] if piece == "norm_modulate" else [()]):
        outs = wrapper(*args, *extra)
        outs = outs if n_out == 2 else (outs,)
        assert all(type(o.grad_fn).__name__.startswith(
            {"norm_modulate": "NormModulate", "conv_norm": "ConvNorm", "act": "Activation"}[piece])
            for o in outs)
        refs = plain(*args, False, *extra[1:])
        refs = refs if n_out == 2 else (refs,)
        assert [o.shape for o in outs] == [r.shape for r in refs]
        gs = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in outs]
        got = torch.autograd.grad(outs, [x, *params], gs)
        ref = torch.autograd.grad(refs, [x, *params], gs)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=0.0, rtol=0.0)
    with pytest.raises(RuntimeError, match="float32 only"):
        wrapper(x.detach().bfloat16().requires_grad_(), *args[1:])
    with torch.no_grad():  # no grad: the launch itself, no Function
        res = wrapper(*args)
        assert all(o.grad_fn is None for o in (res if n_out == 2 else (res,)))


@pytest.mark.parametrize("kernel", ["snake_filtered", "residual_unit", "residual_stack",
                                    "norm_modulate", "conv_norm", "act"])
def test_kernel_wrappers_carry_the_plain_chains_gradient(monkeypatch, kernel):
    """Under grad a wrapper runs its kernel inside a torch.autograd.Function
    whose backward is the plain chain's VJP.  On the CPU the launch is
    stood in for by the plain version, so the Function's forward and
    backward run here: the result has a grad_fn, and the gradients of the
    input and every parameter equal autograd through the plain chain.  A
    bfloat16 input under grad is refused, and so are prepared weights (a
    copy the gradient would not reach)."""
    if kernel in ("norm_modulate", "conv_norm", "act"):
        return _denoiser_gradient(monkeypatch, kernel)
    from flamed_tts_tpu_torch.ops import resunit, snake

    monkeypatch.setattr(snake, "_launch", snake.snake_filtered_reference)
    monkeypatch.setattr(resunit, "_unit_launch",
                        lambda x, p, d, prepared=None: resunit.residual_unit_reference(x, p, d))
    monkeypatch.setattr(resunit, "_stack_launch",
                        lambda x, units, dilations=(1, 3, 9), prepared=None:
                        resunit.residual_stack_reference(x, units, dilations))
    c = 32
    rng = np.random.RandomState(2)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).requires_grad_()

    def unit():
        return {"act1": {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)},
                "act2": {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)},
                "conv1": {"w": rnd(c, c, 7, scale=0.05), "b": rnd(c, scale=0.1)},
                "conv2": {"w": rnd(c, c, 1, scale=0.05), "b": rnd(c, scale=0.1)}}

    units = [unit(), unit(), unit()]
    calls = {"snake_filtered": (lambda x, route: route(x, units[0]["act1"]["alpha"], units[0]["act1"]["beta"]),
                                snake.snake_filtered_cuda, resunit.snake_filtered_reference),
             "residual_unit": (lambda x, route: route(x, units[0], 2),
                               resunit.residual_unit_cuda, resunit.residual_unit_reference),
             "residual_stack": (lambda x, route: route(x, units),
                                resunit.residual_stack_cuda, resunit.residual_stack_reference)}
    call, wrapper, plain = calls[kernel]
    params = ([units[0]["act1"]["alpha"], units[0]["act1"]["beta"]] if kernel == "snake_filtered"
              else [t for p in units[: 1 if kernel == "residual_unit" else 3]
                    for sub in p.values() for t in sub.values()])
    x = rnd(2, 40, c)
    g = torch.from_numpy(rng.randn(2, 40, c).astype(np.float32))
    out = call(x, wrapper)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith(
        {"snake_filtered": "SnakeFiltered", "residual_unit": "ResidualUnit",
         "residual_stack": "ResidualStack"}[kernel])
    got = torch.autograd.grad(out, [x, *params], g)
    ref = torch.autograd.grad(call(x, plain), [x, *params], g)
    assert len(got) == len(params) + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    with pytest.raises(RuntimeError, match="float32 only"):
        call(x.detach().bfloat16().requires_grad_(), wrapper)
    if kernel != "snake_filtered":
        prepared = [{"w1": None, "w2": None}] * 3
        route = ((lambda x, p, d: resunit.residual_unit_cuda(x, p, d, prepared[0]))
                 if kernel == "residual_unit" else
                 (lambda x, u: resunit.residual_stack_cuda(x, u, prepared=prepared)))
        with pytest.raises(ValueError, match="prepared"):
            call(x, route)
    with torch.no_grad():  # no grad: the launch itself, no Function
        assert call(x, wrapper).grad_fn is None


def test_cpu_run_launches_no_kernel():
    from flamed_tts_tpu_torch import kernels
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec

    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu")
    kernels.reset_launches()
    rng = np.random.RandomState(0)
    latents = torch.from_numpy(rng.randn(1, 2, 256).astype(np.float32))
    timbre = torch.from_numpy(rng.randn(1, 256).astype(np.float32))
    wav = codec.decode(latents, timbre)
    assert wav.shape == (1, 400, 1) and torch.isfinite(wav).all()
    assert kernels.launches == {"snake_filtered": 0, "residual_unit": 0, "residual_stack": 0,
                                "norm_modulate": 0, "conv_norm": 0, "act": 0}
    fused = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu", fuse_blocks=True)
    assert torch.equal(fused.decode(latents, timbre), wav)  # on the CPU both are the plain chain
    assert not any(kernels.launches.values())


def test_noise_shape_is_checked():
    from flamed_tts_tpu_torch.runtime.sampler import _noise

    with pytest.raises(ValueError, match="expected"):
        _noise({"dur": np.zeros((1, 3))}, "dur", (1, 4), torch.device("cpu"), None)
