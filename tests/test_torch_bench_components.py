"""The port's component benchmark (``python -m flamed_tts_tpu_torch.
bench_components``) on the CPU at small widths: each mfu stage against the
JAX tool's counterpart at the same weights, FLOP counts against XLA's cost
analysis, the hand kernels' analytic counts whichever route runs, the
polyphase and im2col conv forms, and the CLI's rows against the JAX
tool's."""

import ast
import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.facodec.decoder import analyze as j_analyze
from flamed_tts_tpu.models.facodec.decoder import synthesize as j_synthesize
from flamed_tts_tpu.models.facodec.encoder import encoder_forward as j_encoder_forward
from flamed_tts_tpu.models.prior.prior_generator import PriorGenerator as JPrior
from flamed_tts_tpu.models.prior.sampling import pva_sample as j_pva_sample
from flamed_tts_tpu.models.prob.prob_generator import ProbGenerator as JProb
from flamed_tts_tpu.ops.conv1d import conv1d as j_conv1d
from flamed_tts_tpu.ops.conv1d import conv_transpose1d as j_conv_transpose1d
from flamed_tts_tpu.ops.length_regulator import length_regulate as j_length_regulate

from flamed_tts_tpu_torch import bench_components as bc
from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.models.facodec.decoder import decoder_block
from flamed_tts_tpu_torch.models.facodec.quantize import linear
from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.ops.conv1d import conv1d, conv_transpose1d
from flamed_tts_tpu_torch.ops.resunit import residual_stack, residual_unit, residual_unit_reference
from flamed_tts_tpu_torch.ops.snake import snake_filtered

from torch_parity_utils import ROOT, one_torch_thread, small_config  # noqa: F401

# the small widths: the parity tests' prior and prob, a narrow codec; the
# tool's serving lengths cut (the prompt keeps its 240 frames, 3 s)
SMALL = {"P": 32, "L": 48, "LSRC": 12, "N_ITERS": 2}
BATCH, NFE = 2, 3
# the parity tests' tolerances: prior / prob stacks (tests/test_torch_prior_prob.py),
# the codec (tests/test_torch_codec.py)
TOL = dict(atol=1e-4, rtol=1e-4)
WAV_TOL = dict(atol=2e-5, rtol=1e-4)
# the random narrow encoder's latents reach tens (no trained scale): 1e-5 +
# 1e-5 of the peak, tests/test_torch_extras.py::_grads_equal's rule
PEAK_REL = 1e-5


def small_cfg():
    cfg = small_config()
    cfg["codec_cfg"]["encoder"]["ngf"] = 4
    cfg["codec_cfg"]["decoder"]["upsample_initial_channel"] = 64
    return cfg


@pytest.fixture(scope="module")
def small_tool():
    """The tool's module constants and config at the small widths for the
    module's tests."""
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setattr(bc, k, v)
    mp.setattr(bc, "load_default_config", small_cfg)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def stages(small_tool):
    """The ten mfu stages (fp32, the CPU) and the JAX side at their weights."""
    cfg = small_cfg()
    dev = torch.device("cpu")
    model = bc.make_model(cfg, torch.float32, dev)
    codec = bc.make_codec(cfg, torch.float32, dev)
    with torch.no_grad():
        st, inp = bc.mfu_stages(model, codec, torch.float32, BATCH, NFE, dev)
    rng_dur, rng_sil = jax.random.split(jax.random.PRNGKey(1))
    for key, r in (("dur_noise", rng_dur), ("sil_noise", rng_sil)):
        inp[key] = torch.from_numpy(np.array(jax.random.normal(r, (BATCH, SMALL["LSRC"]))))
    j = {"prior": JPrior(config=cfg["prior_generator"]), "prob": JProb(config=cfg["prob_generator"]),
         "prior_vars": params_to_jax(model.prior.state_dict()),
         "prob_vars": params_to_jax(model.prob.state_dict()),
         "dec": params_to_jax(codec.dec_params), "enc": params_to_jax(codec.enc_params)}
    return st, inp, j


def _np(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _np(v)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)]


def _jax_stage(i, j, a, params):
    """The JAX tool's counterpart of mfu row ``i`` (tools/bench_components.py:359-509)
    on the inputs ``a`` and the parameters ``params``; ``j`` holds the modules."""
    prior, pv, prob, qv = j["prior"], params["prior_vars"], j["prob"], params["prob_vars"]
    if i == 0:
        mods = prob.apply(qv, a["ts"], a["spk"], method="denoiser_mods")
        return prob.apply(qv, a["x"], jax.tree.map(lambda m: m[0], mods), a["pad"],
                          method="denoise_with_mods")
    if i == 1:
        return prior.apply(pv, a["lr_out"], a["tgt_mask"], a["prompts"], a["p_lens"], method="decode")
    if i == 2:
        return j_synthesize(params["dec"], a["lat"], a["timbre"])
    if i == 3:
        return j_encoder_forward(params["enc"], a["wav"])
    if i == 4:
        return prior.apply(pv, a["phonemes"], a["src_mask"], method="encode")
    if i == 5:
        return j_pva_sample(prior, pv, a["enc_out"], a["src_mask"], jax.random.PRNGKey(1), NFE,
                            bc.TEMPERATURE)
    if i == 6:
        return j_length_regulate(a["enc_out"], a["phone_dur"], a["sil_dur"], a["src_lens"], SMALL["L"])[0]
    if i == 7:
        return j_analyze(params["dec"], a["plat"], a["pmask"])
    if i == 8:
        return prob.apply(qv, a["hid"], a["pad"], method="encode_condition")
    return prob.apply(qv, a["ts"], a["spk"], method="denoiser_mods")


MFU_IDS = ["denoiser_step", "prior_decode", "codec_decode", "prompt_encode", "phoneme_encode", "pva",
           "length_regulator", "codec_analyze", "condition_path", "adaln_mods"]


@pytest.mark.parametrize("i", range(10), ids=MFU_IDS)
def test_mfu_stage_matches_the_jax_tool(stages, i):
    st, inp, j = stages
    with torch.no_grad():
        ours = _np(st[i].run())
    params = {k: j[k] for k in ("prior_vars", "prob_vars", "dec", "enc")}
    with jax.default_matmul_precision("highest"):
        theirs = _np(jax.jit(functools.partial(_jax_stage, i, j))(
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), inp), params))
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape
        if i in (5,) or not np.issubdtype(t.dtype, np.floating):
            np.testing.assert_array_equal(o, t)  # durations, RVQ codes
        elif i == 3:
            np.testing.assert_allclose(o, t, atol=PEAK_REL * (1 + np.abs(t).max()), rtol=0)
        else:
            np.testing.assert_allclose(o, t, **(WAV_TOL if i == 2 else TOL))


def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])


def _count(fn):
    with torch.no_grad(), costs.CostCounter() as cc:
        fn()
    return cc


def test_conv_flops_match_xla(small_tool):
    """The pure-conv rows' FLOPs against XLA's cost analysis of the JAX
    tool's conv at the same shapes (zero bias, as the JAX tool's, which XLA
    folds away).  Both count 2 C_in C_out a kernel tap; FlopCounterMode
    counts every tap, XLA the taps that land on the input and not on the
    padding: 12 d of the 7 T taps of a k7 conv at dilation d, and s of the
    2 s T taps of a stride-s conv-transpose."""
    codec = bc.make_codec(small_cfg(), torch.float32, torch.device("cpu"))
    rng = np.random.RandomState(0)
    for t, ci, co, dil in bc.conv1d_shapes(codec):
        x, w = rng.randn(1, t, ci).astype(np.float32), rng.randn(co, ci, 7).astype(np.float32)
        b, pad = np.zeros(co, np.float32), 3 * dil
        ours = _count(lambda: conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                     padding=pad, dilation=dil)).flops
        xla = _xla_flops(lambda v: j_conv1d(v, w, b, padding=pad, dilation=dil), x)
        assert (ours, xla) == (2 * ci * co * 7 * t, 2 * ci * co * (7 * t - 12 * dil))
    for t, ci, co, s in bc._block_shapes(codec, SMALL["L"]):
        k, pad = 2 * s, s // 2 + s % 2
        x, w = rng.randn(1, t, ci).astype(np.float32), rng.randn(ci, co, k).astype(np.float32)
        b = np.zeros(co, np.float32)
        ours = _count(lambda: conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                               stride=s, padding=pad, output_padding=s % 2)).flops
        xla = _xla_flops(lambda v: j_conv_transpose1d(v, w, b, stride=s, padding=pad,
                                                      output_padding=s % 2), x)
        assert (ours, xla) == (2 * ci * co * k * t, 2 * ci * co * (k * t - s))


def test_denoiser_step_flops_against_xla(stages):
    """One denoiser step: the port counts the matmuls and convs
    (FlopCounterMode), XLA every elementwise op too: at these widths the
    port's count is 0.9278 of XLA's (0.9880 at the full widths of
    configs/prob.yaml, L = 48; the matmuls outweigh the elementwise ops
    more there)."""
    st, inp, j = stages
    ours = _count(st[0].run).flops
    a = {k: jnp.asarray(inp[k].numpy()) for k in ("ts", "spk", "x", "pad")}
    prob, qv = j["prob"], j["prob_vars"]
    mods1 = jax.tree.map(lambda m: m[0], prob.apply(qv, a["ts"], a["spk"], method="denoiser_mods"))
    xla = _xla_flops(lambda v, m: prob.apply(qv, v, m, a["pad"], method="denoise_with_mods"), a["x"], mods1)
    assert ours / xla == pytest.approx(0.9278, abs=5e-4), (ours, xla)
    # the row counts the whole loop: nfe steps, each at its own modulations
    assert _count(st[0].count).flops == NFE * ours


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hand_kernel_counts_are_analytic(dtype):
    """A K1 / K2 call counted on the CPU, where its plain version runs, is
    exactly the analytic count (none of the plain chain's aten ops), and a
    block's stack counts K3 where the card would launch K3, else three K2."""
    rng = torch.Generator().manual_seed(0)
    b, t, c = 2, 50, 32
    x = torch.randn((b, t, c), generator=rng).to(dtype)
    act = {"alpha": torch.randn(c, generator=rng) * 0.1, "beta": torch.randn(c, generator=rng) * 0.1}
    unit = {"act1": act, "act2": act,
            "conv1": {"w": (torch.randn((c, c, 7), generator=rng) * 0.05).to(dtype), "b": torch.zeros(c, dtype=dtype)},
            "conv2": {"w": (torch.randn((c, c, 1), generator=rng) * 0.05).to(dtype), "b": torch.zeros(c, dtype=dtype)}}
    cc = _count(lambda: snake_filtered(x, act["alpha"], act["beta"]))
    assert (cc.flops, cc.bytes, cc.kernels) == (*costs.kernel_cost("snake_filtered", b * t, c, dtype),
                                                {"snake_filtered": 1})
    cc = _count(lambda: residual_unit(x, unit, 3))
    assert (cc.flops, cc.bytes, cc.kernels) == (*costs.kernel_cost("residual_unit", b * t, c, dtype),
                                                {"residual_unit": 1})
    for fuse in (False, True):
        cc = _count(lambda: residual_stack(x, [unit] * 3, fuse=fuse))
        name, n = ("residual_stack", 1) if fuse else ("residual_unit", 3)
        flops, nbytes = costs.kernel_cost(name, b * t, c, dtype)
        assert (cc.flops, cc.bytes, cc.kernels) == (n * flops, n * nbytes, {name: n})
    # the counters and their modes are off after a hand kernel, and with no
    # counter a dispatch function runs as before
    assert not costs.counting()
    with torch.no_grad():
        torch.testing.assert_close(residual_unit(x, unit, 3), residual_unit_reference(x, unit, 3))


def test_codec_decode_counts_as_the_sum_of_its_parts(small_tool):
    """A small decode counted whole equals its parts counted one by one
    under nested counters (the outer one sees each part once), hand
    kernels included."""
    codec = bc.make_codec(small_cfg(), torch.float32, torch.device("cpu"))
    dp = codec.dec_params
    rng = np.random.RandomState(3)
    lat = torch.from_numpy(rng.randn(1, 8, 256).astype(np.float32))
    timbre = torch.from_numpy(rng.randn(1, 256).astype(np.float32))
    whole = _count(lambda: codec.decode(lat, timbre))
    parts = []
    with torch.no_grad(), costs.CostCounter() as outer:
        with costs.CostCounter() as c:
            style = linear(timbre, dp["timbre_linear"])
            gamma, beta = style[:, None, :].chunk(2, dim=-1)
            mean = lat.mean(-1, keepdim=True)
            var = ((lat - mean) ** 2).mean(-1, keepdim=True)
            x = (lat - mean) / torch.sqrt(var + 1e-5) * gamma + beta
            x = conv1d(x, dp["stem"]["w"], dp["stem"]["b"], padding=3)
        parts.append(c)
        for blk, s, w in zip(dp["blocks"], codec.up_ratios_dec, codec.dec_prepared):
            with costs.CostCounter() as c:
                x = decoder_block(x, blk, s, prepared=w)
            parts.append(c)
        with costs.CostCounter() as c:
            x = snake_filtered(x, dp["final_act"]["alpha"], dp["final_act"]["beta"])
            torch.tanh(conv1d(x, dp["out"]["w"], dp["out"]["b"], padding=3))
        parts.append(c)
    assert whole.kernels == {"snake_filtered": 5, "residual_unit": 12} == outer.kernels
    assert (whole.flops, whole.bytes) == (outer.flops, outer.bytes)
    assert outer.flops == sum(p.flops for p in parts) and outer.bytes == sum(p.bytes for p in parts)
    assert sum(p.kernel_flops for p in parts) < whole.flops  # the convs count too


def test_bound_formula_and_peaks(monkeypatch):
    """chip_smoke.bound_ms and the tool count with the one formula; the
    peak table refuses a card it does not hold."""
    import chip_smoke

    h100 = costs.PEAKS["NVIDIA H100 80GB HBM3"]
    monkeypatch.setattr(costs, "device_peaks", lambda device=None: h100)
    # K1 (1, 48000, 32) fp32: 2 * 4 * 1536000 + 8 * 32 bytes over 3.35 TB/s
    assert chip_smoke.bound_ms("snake_filtered", 48000, 32, torch.float32) == (
        1e3 * (8 * 48000 * 32 + 256) / 3.35e12, "bytes")
    for name in ("residual_unit", "residual_stack"):
        for dtype in (torch.float32, torch.bfloat16):
            flops, nbytes = costs.kernel_cost(name, 1200, 256, dtype)
            assert chip_smoke.bound_ms(name, 1200, 256, dtype) == costs.bound_ms(flops, nbytes, dtype, h100)
    assert costs.kernel_cost("residual_unit", 1200, 256, torch.float32)[0] == (
        16 * 1200 * 256 ** 2 + 2 * 58 * 1200 * 256 + 2 * 1200 * 256)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no peak rates"):
        costs.device_peaks()


@pytest.mark.parametrize("s", [5, 4, 2, 3])
def test_polyphase_and_im2col_equal_the_library_convs(s):
    rng = np.random.RandomState(s)
    ci, co, t = 12, 8, 37
    k, pad = 2 * s, s // 2 + s % 2
    x = torch.from_numpy(rng.randn(2, t, ci).astype(np.float32))
    w = torch.from_numpy(rng.randn(ci, co, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    ref = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=s, padding=pad,
                             output_padding=s % 2).transpose(1, 2)
    torch.testing.assert_close(bc.poly_conv_transpose(x, bc.poly_weights(w, s, pad), b), ref,
                               atol=1e-5, rtol=0)
    for dil in (1, 3, 9):
        w7 = torch.from_numpy(rng.randn(co, ci, 7).astype(np.float32))
        ref = F.conv1d(x.transpose(1, 2), w7, b, padding=3 * dil, dilation=dil).transpose(1, 2)
        torch.testing.assert_close(bc.im2col_conv(x, bc.im2col_weights(w7), b, 7, dil), ref,
                                   atol=1e-5, rtol=0)


def _jax_mfu_names(env):
    """The JAX tool's mfu row names (its ``_mfu_row`` calls), formatted."""
    with open(os.path.join(ROOT, "tools", "bench_components.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_mfu_row"
                and not isinstance(node.args[0], ast.Name)):
            names.append((node.lineno, eval(compile(ast.Expression(node.args[0]), "<row>", "eval"), {}, env)))
    return [n for _, n in sorted(names)]


def _expected_names(section, codec):
    L, P = SMALL["L"], SMALL["P"]
    blocks = bc._block_shapes(codec, L)
    stem = codec.dec_params["stem"]["w"]
    if section == "codec":
        names, t, c = ["codec synthesize total", f"stem conv {stem.shape[1]}->{stem.shape[0]} @ {L}"], L, stem.shape[0]
        for i, (_, _, _, s) in enumerate(blocks):
            names.append(f"block{i} C{c}->{c // 2} L{t} stride{s}")
            t, c = t * s, c // 2
        return names
    if section == "pieces":
        return [f"block{i} L{t} C{ci}: {p}" for i, (t, ci, _, _) in enumerate(blocks)
                for p in ("snake", "convT", "res x3")]
    if section == "prior":
        return [f"prior decode (shared+6 dec, {P}+{L})"]
    if section == "convforms":
        return ([f"convT L{t} {ci}->{co} s{s}: {p}" for t, ci, co, s in blocks for p in ("convT", "poly")]
                + [f"conv1d L{t} {ci}->{co} d{d}: {p}" for t, ci, co, d in bc.conv1d_shapes(codec)
                   for p in ("conv", "im2col")])
    return _jax_mfu_names({"NFE": NFE, "P": P, "L": L, "Lsrc": SMALL["LSRC"], "Lp": bc.PROMPT_FRAMES})


@pytest.mark.parametrize("section", list(bc.SECTIONS))
def test_cli_on_the_cpu(small_tool, capsys, section):
    """``--which <section> --device cpu``: the rows in the JAX tool's order
    and names, finite, counted, and the JSON line last."""
    out = bc.main(["--which", section, "--device", "cpu", "--dtype", "fp32", "--batch", str(BATCH),
                   "--nfe", str(NFE)])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert report == json.loads(json.dumps(out["report"]))
    rows = report["rows"]
    assert [r["name"] for r in rows] == _expected_names(section, out["codec"])
    assert {r["section"] for r in rows} == {section}
    assert all(r["timing"] == "host" and np.isfinite(r["ms"]) and r["ms"] > 0 and r["flop_pct"] is None
               for r in rows)
    assert all(r["gflop"] > 0 for r in rows if "regulator" not in r["name"])
    if section == "mfu":
        total = report["total"]
        assert total["audio_s"] == BATCH * SMALL["L"] * 200 / 16000 and total["mfu_whole_call"] is None
        assert total["compute_ms"] == pytest.approx(sum(r["ms"] for r in rows))
        assert rows[2]["kernel_calls"] == {"snake_filtered": 5, "residual_unit": 12}
    if section == "convforms":
        assert all(r["max_abs_err"] < 1e-4 for r in rows)
    with pytest.raises(SystemExit):
        bc.main(["--which", "mfu,nope", "--device", "cpu"])
