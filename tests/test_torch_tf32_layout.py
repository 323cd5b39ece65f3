"""The host side and the arithmetic of the float32 tensor-core convs of K2
and K3, and of the kernels' sin^2, on the CPU:

* the float32 weight packing (B fragments of ``mma.sync`` m16n8k8) is a
  permutation with an exact inverse and is the order the kernel reads;
* a plain-torch emulation of the split product (each operand as a TF32
  value and its remainder, three products, the small ones first) against a
  float64 product
  and against a single TF32 product;
* the constants ``ops/resunit.py`` mirrors from ``csrc/resunit.cuh``;
* a plain-torch twin of ``sin2`` in ``csrc/snake.cuh`` (argument reduced by
  the period pi, then a polynomial), built from the constants in that file,
  against ``torch.sin(x) ** 2`` in float64.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda_kernels.py."""

import os
import re

import numpy as np
import pytest
import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops import resunit
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resunit import pack_mma_weights, packed_shape, unpack_mma_weights


def _defines(header: str) -> dict:
    """{name: literal} of the ``#define NAME literal`` lines of a csrc header."""
    with open(os.path.join(kernels.CSRC_DIR, header)) as f:
        return dict(re.findall(r"^#define (\w+) (-?[\d.]+(?:e[-+]?\d+)?)f?\b", f.read(), re.M))


@pytest.mark.parametrize("k", [7, 1])
@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
def test_fp32_pack_round_trips_and_permutes(c, k):
    w = torch.arange(c * c * k, dtype=torch.float32).reshape(c, c, k)  # exact up to 2^24
    packed = pack_mma_weights(w)
    assert packed.shape == (k * c // 8, c // 16, 32, 4) == packed_shape(c, k, torch.float32)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert torch.equal(unpack_mma_weights(packed, k), w)
    # every value exactly once
    assert torch.equal(packed.flatten().sort().values, w.flatten())


@pytest.mark.parametrize("c", [32, 96])
def test_fp32_packed_order_is_the_mma_b_fragment(c):
    """Slab s = tap * C / 8 + ci / 8, block co / 16, lane l, value e: the
    lane's registers b0 (e = 0), b1 (e = 1) of the n8 tile h = 0, then of
    h = 1, holding rows ci % 8 = l % 4 (+ 4 for b1) of column
    co % 16 = 8 h + l // 4, as mma.sync m16n8k8 wants its B operand."""
    rng = np.random.RandomState(c)
    w = torch.from_numpy(rng.randn(c, c, 7).astype(np.float32))
    packed = pack_mma_weights(w)
    s, n16, lane, e = np.meshgrid(np.arange(7 * c // 8), np.arange(c // 16), np.arange(32),
                                  np.arange(4), indexing="ij")
    tap, cib = s // (c // 8), s % (c // 8)
    h, reg = e // 2, e % 2
    ci = cib * 8 + lane % 4 + 4 * reg
    co = n16 * 16 + h * 8 + lane // 4
    assert torch.equal(packed, w[torch.from_numpy(co), torch.from_numpy(ci), torch.from_numpy(tap)])


@pytest.mark.parametrize("c,dil", [(32, 1), (96, 3), (64, 9)])
def test_fp32_slab_order_product_is_the_conv(c, dil):
    """The implicit GEMM the float32 kernel runs, emulated: for each slab in
    order, A = the input rows shifted by tap * dil, 8 channels wide, times
    the slab's 8 x C block read back from the packed order."""
    rng = np.random.RandomState(dil)
    rows = 40
    w = torch.from_numpy(rng.randn(c, c, 7).astype(np.float32)) / np.sqrt(7 * c)
    x = torch.from_numpy(rng.randn(rows + 6 * dil, c).astype(np.float32))
    packed = pack_mma_weights(w)
    blocks = unpack_mma_weights(packed, 7).permute(2, 1, 0)  # [tap][ci][co]
    acc = torch.zeros(rows, c)
    for s in range(packed.shape[0]):
        tap, cib = divmod(s, c // 8)
        acc += x[tap * dil: tap * dil + rows, cib * 8: cib * 8 + 8] @ blocks[tap, cib * 8: cib * 8 + 8]
    torch.testing.assert_close(acc, conv1d(x[None], w, dilation=dil)[0], atol=1e-5, rtol=1e-5)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero (half a TF32 step added to the magnitude,
    then the 13 low bits cut)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor):
    """split_tf32 of csrc/resunit.cuh: hi rounded to TF32, lo the exact
    remainder as the tensor cores read it, its 13 low bits cut."""
    hi = _tf32(v)
    return hi, ((v - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_split_tf32_halves():
    rng = np.random.RandomState(0)
    v = torch.from_numpy((rng.randn(100000) * np.exp(rng.uniform(-20, 20, 100000))).astype(np.float32))
    hi, lo = _split(v)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
    assert torch.equal(lo.view(torch.int32) & 0x1FFF, torch.zeros_like(lo, dtype=torch.int32))
    # hi is within half a TF32 step (2^-11 relative), hi + lo within 2^-21
    assert ((v - hi).abs() <= v.abs() * 2.0 ** -11).all()
    assert ((v.double() - hi.double() - lo.double()).abs() <= v.abs().double() * 2.0 ** -21).all()


def test_three_tf32_products_keep_fp32_digits():
    """a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first, each
    product exact (11 x 11 bits) and each sum rounded to float32 as the
    mma's accumulator is: within 2^-20 of the float64 product, relative,
    where a single TF32 product is up to 2^-10 off and a float32 product
    2^-24."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(200000).astype(np.float32))
    b = torch.from_numpy(rng.randn(200000).astype(np.float32))
    exact = a.double() * b.double()
    ah, al = _split(a)
    bh, bl = _split(b)
    three = (al * bh + ah * bl) + ah * bh
    one = ah * bh
    rel3 = ((three.double() - exact).abs() / exact.abs()).max().item()
    rel1 = ((one.double() - exact).abs() / exact.abs()).max().item()
    assert rel3 <= 2.0 ** -20, rel3
    assert 2.0 ** -12 < rel1 <= 2.0 ** -10, rel1
    assert rel3 * 500 < rel1


@pytest.mark.parametrize("c", [32, 512])
def test_split_product_conv_sum_against_float64(c):
    """A conv output's whole sum (7 taps x C channels) by the split, in the
    kernel's order: a K step's three products summed from zero, the small
    ones first, and the step's sum added to the running sum in float32.  (The
    tensor cores add by truncation, which no CPU sum shows; that is why the
    kernel keeps the running sum out of them.)  As close to the float64 sum
    as the plain float32 sum is, and hundreds of times closer than single
    TF32 products."""
    rng = np.random.RandomState(c)
    n = 7 * c
    a = torch.from_numpy(rng.randn(64, n).astype(np.float32))
    b = torch.from_numpy((rng.randn(n, 32) / np.sqrt(n)).astype(np.float32))
    exact = a.double() @ b.double()
    ah, al = _split(a)
    bh, bl = _split(b)
    acc3, acc1, plain = torch.zeros(64, 32), torch.zeros(64, 32), torch.zeros(64, 32)
    for k0 in range(0, n, 8):  # one K step of m16n8k8 at a time
        s = slice(k0, k0 + 8)
        acc3 = acc3 + ((al[:, s] @ bh[s] + ah[:, s] @ bl[s]) + ah[:, s] @ bh[s])
        acc1 = acc1 + ah[:, s] @ bh[s]
        plain = plain + a[:, s] @ b[s]
    err3 = (acc3.double() - exact).abs().max().item()
    err1 = (acc1.double() - exact).abs().max().item()
    errp = (plain.double() - exact).abs().max().item()
    assert err3 <= 2 * errp + 1e-7, (err3, errp)
    assert err3 * 100 < err1, (err3, err1)


def test_python_constants_mirror_the_cuda_header():
    d = _defines("resunit.cuh")
    assert int(d["SMEM_LIMIT"]) == resunit.SMEM_LIMIT
    assert int(d["MMA_PAD_BYTES"]) == resunit.MMA_PAD_BYTES
    assert int(d["MMA_STAGE_BYTES"]) == resunit.MMA_STAGE_BYTES
    assert int(d["MMA_STAGES"]) == resunit.MMA_STAGES
    assert int(d["MMA_MAX_C"]) == resunit.MMA_MAX_C
    assert int(d["MMA_PASS_BYTES"]) == resunit.MMA_PASS_BYTES
    # a pass of conv_mma stages one 32-channel group of each K step's slab
    # for each of its items, at most one item a warp: the 16 warps of the
    # widest block fill a stage exactly, whatever C is
    assert (512 // 32) * 32 * resunit.MMA_STEP_BYTES == resunit.MMA_STAGE_BYTES
    with open(os.path.join(kernels.CSRC_DIR, "resunit.cuh")) as f:
        text = f.read()
    assert "conv_rows" not in text and "fmaf(h." not in text  # the scalar-FMA route is gone


def _sin2_twin(y: torch.Tensor) -> torch.Tensor:
    """``sin2`` of csrc/snake.cuh in float32, operation by operation.  A
    fused multiply-add is a float64 multiply-add rounded to float32 (the
    product of two floats is exact in float64)."""
    d = {k: torch.tensor(float(v), dtype=torch.float32) for k, v in _defines("snake.cuh").items()
         if k.startswith("SIN2_")}

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    k = torch.round(y * d["SIN2_INV_PI"])  # rintf: to nearest, ties to even
    r = fma(-k, d["SIN2_PI_HI"], y)
    r = fma(-k, d["SIN2_PI_LO"], r)
    z = r * r
    poly = fma(d["SIN2_C3"], z, d["SIN2_C2"])
    poly = fma(poly, z, d["SIN2_C1"])
    poly = fma(poly, z, d["SIN2_C0"])
    sn = fma(r * z, poly, r)
    return sn * sn


# the codec's alpha * u reaches a few hundred; SIN2_MAX_ARG is where the kernel hands over to sinf
@pytest.mark.parametrize("bound", [3.0, 400.0, 65536.0])
def test_sin2_reduction_twin_against_torch_sin(bound):
    assert float(_defines("snake.cuh")["SIN2_MAX_ARG"]) == 65536.0
    rng = np.random.RandomState(int(bound))
    y = torch.from_numpy(np.concatenate([
        rng.uniform(-bound, bound, 400000),
        np.linspace(-bound, bound, 200001),
        (np.arange(-200, 201) + 0.5) * np.pi * min(1.0, bound / 700),  # near the reduction's seams
    ]).astype(np.float32))
    exact = torch.sin(y.double()) ** 2
    err = (_sin2_twin(y).double() - exact).abs().max().item()
    lib = ((torch.sin(y) ** 2).double() - exact).abs().max().item()
    # 4e-7: two roundings of r (1.2e-7 together at |r| <= pi / 2), the polynomial's 1.2e-7
    # on sin, doubled by the square, and the square's rounding; the library's sin: 1.2e-7
    assert err <= 4e-7, err
    assert lib <= 1.3e-7, lib


def test_sin2_reduction_lands_in_the_polynomials_range():
    d = {k: float(v) for k, v in _defines("snake.cuh").items()}
    y = torch.linspace(-65536.0, 65536.0, 1000001)
    k = torch.round(y * torch.tensor(d["SIN2_INV_PI"]))
    r = (y.double() - k.double() * d["SIN2_PI_HI"] - k.double() * d["SIN2_PI_LO"])
    assert r.abs().max().item() <= 1.62  # the range the coefficients were fitted on
    assert abs(d["SIN2_PI_HI"] + d["SIN2_PI_LO"] - np.pi) < 1e-14
