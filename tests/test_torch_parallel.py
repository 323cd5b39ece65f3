"""Data and tensor parallelism of the port (``flamed_tts_tpu_torch/parallel/``,
``train/step.py`` on a mesh, ``sample_batch(mesh=)``) on the CPU: gloo
worlds of 2 and 4 processes (``torch.multiprocessing`` spawn) at small
widths, each held to one process on the whole batch, and the split rules
to the JAX package's (``flamed_tts_tpu/parallel/sharding.py``)."""

import jax
import numpy as np
import pytest
import torch

from flamed_tts_tpu.models.flamed import Flamed as JFlamed
from flamed_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from flamed_tts_tpu.parallel.sharding import param_spec as j_param_spec
from flamed_tts_tpu.train.step import init_train_state as j_init_train_state
from flamed_tts_tpu.train.step import jit_train_step_on_mesh
from flamed_tts_tpu.train.step import make_optimizer as j_make_optimizer
from flamed_tts_tpu.train.step import make_train_step as j_make_train_step
from flamed_tts_tpu.train.step import shard_batch as j_shard_batch

from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.parallel.sharding import flax_path, param_spec

from torch_parallel_worker import (_assert_params_close, _batch, _cfg, _opt_cfg, _params, _run,
                                   _sample, _sample_inputs, _step)

# the JAX package's tests of the same equalities (tests/test_training.py)
DP_RTOL = 1e-4                       # test_dp_equals_single_device
TP_LOSS_RTOL, TP_NORM_RTOL = 2e-5, 2e-4  # test_tp_equals_replicated
TP_PARAM_ATOL, TP_PARAM_RTOL = 2e-5, 2e-4


def _jax_draws(rng, b, l, lf):
    """The draws JAX's compute_losses makes from ``rng``, replayed
    (tests/test_torch_train.py)."""
    rng_pva, rng_prob = jax.random.split(rng, 5)[:2]
    rng_t, rng_d0, rng_s0 = jax.random.split(rng_pva, 3)
    rng_pt, rng_pn = jax.random.split(rng_prob)
    return {"pva_t": np.asarray(jax.random.uniform(rng_t, (b, 1))),
            "dur_noise": np.asarray(jax.random.normal(rng_d0, (b, l))),
            "sil_noise": np.asarray(jax.random.normal(rng_s0, (b, l))),
            "prob_t": np.asarray(jax.random.uniform(rng_pt, (b, lf, 1))),
            "prob_noise": np.asarray(jax.random.normal(rng_pn, (b, lf, 256)))}


# --- the parent: references and checks -------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    """One world of 2 processes runs every 2-rank job; the references run
    here, in one process."""
    cfg, cfg_nd = _cfg(), _cfg(dropout=False)
    params, params_nd = _params(cfg), _params(cfg_nd, seed=1)
    batch = _batch(3, 4)
    # unequal valid counts: rank 0's rows are long, rank 1's short
    uneven = _batch(5, 4, lengths=[15, 14, 6, 5])
    rng = jax.random.PRNGKey(9)
    b, l = uneven["phonemes"].shape
    draws = _jax_draws(rng, b, l, uneven["codes"].shape[-1])
    inputs = _sample_inputs(3)
    jobs = {"error": {"kind": "mesh_error"},
            "dp": {"kind": "step", "n_data": 2, "n_model": 1, "cfg": cfg, "params": params, "batch": batch},
            "tp": {"kind": "step", "n_data": 1, "n_model": 2, "cfg": cfg, "params": params, "batch": batch},
            "uneven": {"kind": "step", "n_data": 2, "n_model": 1, "cfg": cfg_nd, "params": params_nd,
                       "batch": uneven, "draws": draws},
            "sample_fused": {"kind": "sample", "n_data": 2, "n_model": 1, "cfg": cfg, "params": params,
                             "inputs": inputs, "fused": True},
            "sample_staged": {"kind": "sample", "n_data": 2, "n_model": 1, "cfg": cfg, "params": params,
                              "inputs": inputs, "fused": False}}
    results = _run(2, jobs)
    refs = {"step": _step(cfg, params, batch),
            "sample_fused": _sample(cfg, params, inputs, fused=True),
            "sample_staged": _sample(cfg, params, inputs, fused=False)}
    return {"results": results, "refs": refs, "uneven": (cfg_nd, params_nd, uneven, rng)}


def test_param_spec_equals_jax_on_every_leaf():
    """The split axis of every leaf of a full-width parameter tree (the
    configs' widths): the JAX rule's flax axis, carried to the port's
    layout, on the same npz path."""
    cfg = load_default_config()
    model = Flamed(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    n_split = 0
    for part, module in (("prior", model.prior), ("prob", model.prob)):
        tree = params_to_jax(module.state_dict())
        flat = jax.tree_util.tree_flatten_with_path({part: tree})[0]
        port = {flax_path(n, p.dim()): tuple(p.shape) for n, p in module.state_dict().items()}
        for path, leaf in flat:
            spec = j_param_spec(path, leaf)
            keys = "/".join(str(getattr(e, "key", getattr(e, "idx", None))) for e in path)
            local = keys.split("/params/", 1)[1]
            axis = param_spec(keys, port[local])
            if "model" not in tuple(spec):
                assert axis is None, keys
                continue
            n_split += 1
            flax_axis = tuple(spec).index("model")
            if leaf.ndim == 1 or not keys.endswith("kernel"):
                assert axis == flax_axis, keys
            else:  # the port's layout reverses a kernel's axes
                assert axis == leaf.ndim - 1 - flax_axis, keys
            assert port[local][axis] == leaf.shape[flax_axis], keys
    assert n_split > 40  # the denoiser's pairs, convs and norms, block by block


def test_make_mesh_raises_the_jax_error(two_ranks):
    with pytest.raises(ValueError) as ref:
        j_make_mesh(n_data=3, n_model=1, devices=jax.devices()[:2])
    for r in two_ranks["results"]:
        assert r["error"] == str(ref.value) == "mesh 3x1 != 2 devices"


def _check_step(result, ref, loss_rtol, norm_rtol, atol, rtol):
    metrics, params = result
    ref_metrics, ref_params = ref
    for k in ("total_loss", "dur_loss", "sil_loss", "prior_loss", "fm_loss", "anchor_loss"):
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=loss_rtol, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"], ref_metrics["grad_norm"], rtol=norm_rtol)
    _assert_params_close(params, ref_params, atol, rtol)


def test_two_data_ranks_equal_one_process(two_ranks):
    """2 x 1: each rank 2 rows of a batch of 4, dropout on; the losses,
    grad_norm and every parameter after the step of one process on the 4."""
    for r in two_ranks["results"]:
        _check_step(r["dp"], two_ranks["refs"]["step"], DP_RTOL, DP_RTOL, 1e-6, DP_RTOL)


def test_tensor_parallel_equals_replicated(two_ranks):
    """1 x 2: the denoiser split over two ranks, the whole batch on each."""
    hidden = two_ranks["refs"]["step"][0]["hidden_rows"]
    for r in two_ranks["results"]:
        assert r["tp"][0]["hidden_rows"] == hidden / 2
        _check_step(r["tp"], two_ranks["refs"]["step"], TP_LOSS_RTOL, TP_NORM_RTOL,
                    TP_PARAM_ATOL, TP_PARAM_RTOL)


def test_unequal_valid_counts_equal_the_jax_sharded_step(two_ranks):
    """Rank 0 holds two long utterances, rank 1 two short ones: the means
    are the whole batch's (numerators and denominators summed over the
    ranks), as in the JAX step on a 2 x 1 mesh with the same batch and
    draws; dropout off."""
    cfg, params, batch, rng = two_ranks["uneven"]
    jmodel = JFlamed(cfg, rng=jax.random.PRNGKey(0))
    jparams = {k: params_to_jax(params[k]) for k in ("prior", "prob")}
    tx, _ = j_make_optimizer(_opt_cfg())
    state = j_init_train_state(jparams, tx)
    mesh = j_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    with mesh:
        jitted, state = jit_train_step_on_mesh(
            j_make_train_step(jmodel.prior_module, jmodel.prob_module, tx), state, mesh)
        state, j_metrics = jitted(state, j_shard_batch(batch, mesh), rng)
    valid = batch["y_len"]
    assert valid[:2].sum() > 2 * valid[2:].sum()  # the ranks' counts differ
    ref = ({k: float(v) for k, v in j_metrics.items()}, jax.device_get(state.params))
    for r in two_ranks["results"]:
        metrics, params_after = r["uneven"]
        for k in ("total_loss", "dur_loss", "sil_loss", "prior_loss", "fm_loss", "anchor_loss"):
            np.testing.assert_allclose(metrics[k], ref[0][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(metrics["grad_norm"], ref[0]["grad_norm"], rtol=1e-4)
        _assert_params_close(params_after, ref[1], 1e-5, 0)


@pytest.mark.parametrize("path", ["sample_fused", "sample_staged"])
def test_sample_batch_on_two_ranks_equals_no_mesh(two_ranks, path):
    """A batch of 3 on 2 data ranks (padded to 4 with row 0): every rank
    returns the 3 rows of the call without a mesh; integers exactly."""
    ref = two_ranks["refs"][path]
    for r in two_ranks["results"]:
        out = r[path]
        assert out["frame_bucket"] == ref["frame_bucket"]
        np.testing.assert_array_equal(out["tgt_len"], ref["tgt_len"])
        np.testing.assert_array_equal(out["tgt_mask"], ref["tgt_mask"])
        assert out["latents"].shape[0] == 3
        torch.testing.assert_close(out["latents"], ref["latents"], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(out["prior_logits"], ref["prior_logits"], atol=1e-4, rtol=1e-4)


def test_two_by_two_step_equals_one_process():
    """2 x 2 on 4 ranks: each data rank 2 rows, the denoiser split in two;
    finite, and the step of one process on the whole batch."""
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(3, 4)
    jobs = {"dp_tp": {"kind": "step", "n_data": 2, "n_model": 2, "cfg": cfg, "params": params,
                      "batch": batch}}
    ref = _step(cfg, params, batch)
    for r in _run(4, jobs):
        metrics, _ = r["dp_tp"]
        assert all(np.isfinite(v) for v in metrics.values())
        assert metrics["hidden_rows"] == ref[0]["hidden_rows"] / 2
        _check_step(r["dp_tp"], ref, TP_LOSS_RTOL, TP_NORM_RTOL, TP_PARAM_ATOL, TP_PARAM_RTOL)
