"""The per-rank side of tests/test_torch_parallel.py: model, batch and
step helpers and the worker each spawned process runs.  Imports torch and
the port only, so that a spawned rank starts quickly."""

import copy
import os
import socket
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from flamed_tts_tpu_torch.config import load_yaml
from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.data.dataset import BucketedCollator
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator
from flamed_tts_tpu_torch.parallel import mesh as port_mesh
from flamed_tts_tpu_torch.parallel.sharding import full_state_dict
from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree
from flamed_tts_tpu_torch.train.step import (batch_to_device, init_train_state, place_train_state,
                                             train_step)

from torch_parity_utils import ROOT, small_config


def _opt_cfg():
    """No warmup, so the first step moves the weights; eps 1e-4 (as in
    tests/test_torch_train.py): a gradient that is rounding noise (the
    attention's key biases) then moves its parameter by ~lr / 10^4 on
    either side, not by +-lr."""
    return dict(load_yaml(os.path.join(ROOT, "configs", "optimizer.yaml")),
                lr=1e-3, warmup_steps=0, max_steps=10, eps=1e-4)


def _cfg(dropout=True):
    cfg = small_config()
    if not dropout:
        t = cfg["prior_generator"]["transformer"]
        t["encoder_dropout"] = t["decoder_dropout"] = 0.0
        for g in ("duration_generator", "sil_generator"):
            cfg["prior_generator"]["variance_adaptor"][g]["drop_out"] = 0.0
    return cfg


def _params(cfg, seed=0):
    model = Flamed(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return {"prior": copy.deepcopy(model.prior.state_dict()), "prob": copy.deepcopy(model.prob.state_dict())}


def _batch(seed, n, lengths=None):
    """A collated batch of ``n`` random samples (phoneme counts ``lengths``
    where given), at one bucket shape."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        l = int(lengths[i]) if lengths is not None else int(rng.randint(6, 15))
        phone_dur = rng.randint(1, 5, l).astype(np.int32)
        sil_dur = ((rng.rand(l) < 0.3) * rng.randint(0, 4, l)).astype(np.int32)
        lf = int(phone_dur.sum() + sil_dur.sum())
        items.append({"phoneme": rng.randint(1, 300, l).astype(np.int32),
                      "code": rng.randint(0, 1024, (6, lf)).astype(np.int32),
                      "emb": rng.randn(lf, 256).astype(np.float32),
                      "spk": rng.randn(256).astype(np.float32),
                      "phone_dur": phone_dur, "sil_dur": sil_dur})
    collator = BucketedCollator(prompt_max_len=40, phoneme_buckets=[16], frame_buckets=[128],
                                prompt_buckets=[32], seed=seed)
    return collator(items)


def _modules(cfg, params):
    prior = PriorGenerator(cfg["prior_generator"])
    prior.load_state_dict(params["prior"])
    prob = ProbGenerator(cfg["prob_generator"])
    prob.load_state_dict(params["prob"])
    return prior, prob


def _step(cfg, params, batch, mesh=None, draws=None):
    """One train step from ``params`` on ``batch`` (this rank's rows of it
    on a mesh): (metrics, whole parameters after it)."""
    prior, prob = _modules(cfg, params)
    state = init_train_state(prior, prob, _opt_cfg(), seed=7)
    if mesh is not None:
        place_train_state(state, mesh)
        lo, hi = port_mesh.rows_of(len(batch["phonemes"]), mesh)
        batch = {k: v[lo:hi] for k, v in batch.items()}
        if draws is not None:
            draws = {k: v[lo:hi] for k, v in draws.items()}
    metrics = train_step(state, batch_to_device(batch, "cpu"),
                         draws=None if draws is None else {k: torch.from_numpy(np.asarray(v))
                                                           for k, v in draws.items()},
                         mesh=mesh)
    # the rows of the split hidden width this rank holds (all of them without a split)
    metrics["hidden_rows"] = prob.denoiser.proj_in.weight.shape[0]
    return ({k: float(v) for k, v in metrics.items()},
            {"prior": params_to_jax(prior.state_dict()), "prob": params_to_jax(full_state_dict(prob))})


def _sample(cfg, params, inputs, mesh=None, fused=True):
    model = Flamed(cfg, params=params, device="cpu")
    out = model.sample_batch(**inputs, nsteps_durgen=3, nsteps_denoiser=3, seed=11, fused=fused,
                             mesh=mesh)
    return {k: out[k] for k in ("latents", "tgt_len", "tgt_mask", "frame_bucket", "prior_logits")}


def _sample_inputs(b):
    rng = np.random.RandomState(4)
    return {"phonemes": rng.randint(1, 300, (b, 12)).astype(np.int64),
            "src_lens": np.array([12, 9, 7][:b], np.int64),
            "prompts": rng.randint(0, 1024, (b, 6, 20)).astype(np.int64),
            "prompt_lens": np.array([20, 14, 17][:b], np.int64),
            "timbres": rng.randn(b, 256).astype(np.float32)}


# --- the workers (one process each rank) -----------------------------------

def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    # the jobs come from a file: tensors handed to spawn go through shared
    # memory one by one, which costs seconds for a model's parameters
    jobs = torch.load(os.path.join(out_dir, "jobs.pt"), weights_only=False)
    port_mesh.init_distributed("cpu", f"tcp://127.0.0.1:{port}", world, rank)
    results = {}
    try:
        for name, job in jobs.items():
            if job["kind"] == "mesh_error":
                try:
                    port_mesh.make_mesh(world + 1, 1, "cpu")
                except ValueError as exc:
                    results[name] = str(exc)
                continue
            mesh = port_mesh.make_mesh(job["n_data"], job["n_model"], "cpu")
            if job["kind"] == "step":
                results[name] = _step(job["cfg"], job["params"], job["batch"], mesh, job.get("draws"))
            else:
                results[name] = _sample(job["cfg"], job["params"], job["inputs"], mesh, job["fused"])
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(world, jobs):
    """Every rank's results of ``jobs``."""
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(jobs, os.path.join(out_dir, "jobs.pt"))
        mp.spawn(_worker, args=(world, _free_port(), out_dir), nprocs=world, join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _assert_params_close(ours, ref, atol, rtol):
    a, b = flatten_pytree(ours), flatten_pytree(ref)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol, err_msg=k)
