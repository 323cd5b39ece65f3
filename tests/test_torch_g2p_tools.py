"""The port's G2P tools against the JAX package's ``tools/``:
``train_g2p`` (dataset, split, arrays and initial parameters bit for bit;
one update against the JAX tool's optax step on the same batch and dropout
masks; the saved weights read by both packages' ``neural_g2p`` with the
same transcriptions), ``expand_lexicon`` (the same file, byte for byte) and
``lexicon_coverage`` (the same JSON line), on the CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flamed_tts_tpu.text import neural_g2p as jax_g2p

from flamed_tts_tpu_torch import expand_lexicon, lexicon_coverage, train_g2p
from flamed_tts_tpu_torch.text import neural_g2p as port_g2p

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_train_g2p():
    return _tool("train_g2p")


@pytest.fixture(scope="module")
def datasets(jax_train_g2p):
    return train_g2p.build_dataset(), jax_train_g2p.build_dataset()


def test_dataset_split_and_arrays_equal_the_jax_tool(datasets, jax_train_g2p):
    ours, ref = datasets
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a == b  # dicts (same keys, same phone lists) and counts
    train_lex, names = ours[0], ours[1]
    pairs = sorted(train_lex.items()) + 4 * sorted(names.items())
    src, tgt = train_g2p.to_arrays(pairs)
    src_j, tgt_j = jax_train_g2p.to_arrays(pairs)
    assert src.dtype == src_j.dtype and np.array_equal(src, src_j)
    assert tgt.dtype == tgt_j.dtype and np.array_equal(tgt, tgt_j)


def test_initial_parameters_equal_the_jax_tool(jax_train_g2p):
    ours = port_g2p.flatten(train_g2p.init_params(np.random.RandomState(3)))
    ref = jax_g2p.flatten(jax_train_g2p.init_params(np.random.RandomState(3)))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_one_step_equals_the_jax_tools_step(datasets):
    """Two updates from the same parameters on the same batches and dropout
    masks, against the JAX tool's step (its loss and optax chain): the
    losses and every parameter after them, the position table included
    (trained as in the JAX tool).  Two, because at 20 steps in all the
    schedule warms up over 2 and the first update has lr 0."""
    args = {"lr": 3e-4, "dropout": 0.15, "label_smooth": 0.1}
    train_lex, names = datasets[0][0], datasets[0][1]
    src, tgt = train_g2p.to_arrays(sorted(train_lex.items())[:48])
    params = train_g2p.init_params(np.random.RandomState(0))
    params["pos"] = port_g2p.sinusoid_table(max(port_g2p.MAX_SRC, port_g2p.MAX_TGT), port_g2p.D_MODEL)
    total = 20
    rng = np.random.RandomState(5)
    batches = [(src[i * 16:(i + 1) * 16], tgt[i * 16:(i + 1) * 16]) for i in range(2)]
    masks = [[rng.rand(16, port_g2p.MAX_SRC, port_g2p.D_MODEL) >= args["dropout"]
              for _ in range(2 * port_g2p.N_ENC)]
             + [rng.rand(16, port_g2p.MAX_TGT - 1, port_g2p.D_MODEL) >= args["dropout"]
                for _ in range(3 * port_g2p.N_DEC)] for _ in batches]

    p = train_g2p.tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), params)
    opt = train_g2p.make_optimizer(p, args["lr"], total)
    losses = [float(train_g2p.train_step(p, opt, torch.from_numpy(s), torch.from_numpy(t),
                                         [torch.from_numpy(m) for m in ms], args["dropout"],
                                         args["label_smooth"]))
              for (s, t), ms in zip(batches, masks)]

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref_losses = []
    # the JAX step keeps its optax state across the two updates
    sched = optax.warmup_cosine_decay_schedule(0.0, args["lr"], min(1000, total // 10), total,
                                               args["lr"] * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))
    state = tx.init(jparams)
    for (s, t), ms in zip(batches, masks):
        def loss_fn(q):
            calls = iter(ms)

            def drop(x):
                return jnp.where(next(calls), x / (1.0 - args["dropout"]), 0.0)

            logits = jax_g2p.forward_logits(q, jnp, jnp.asarray(s), jnp.asarray(t[:, :-1]), drop)
            tgt_out = jnp.asarray(t[:, 1:])
            valid = (tgt_out != jax_g2p.PAD).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits, axis=-1)
            smoothed = ((1 - args["label_smooth"]) * jax.nn.one_hot(tgt_out, jax_g2p.TGT_SIZE)
                        + args["label_smooth"] / jax_g2p.TGT_SIZE)
            return (-(smoothed * logp).sum(-1) * valid).sum() / valid.sum()

        with jax.default_matmul_precision("highest"):
            loss, grads = jax.value_and_grad(loss_fn)(jparams)
            updates, state = tx.update(grads, state, jparams)
            jparams = optax.apply_updates(jparams, updates)
        ref_losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    ours = port_g2p.flatten(train_g2p.tree_map(lambda t: t.detach().numpy(), p))
    ref = jax_g2p.flatten(jax.device_get(jparams))
    assert ours.keys() == ref.keys()
    moved = 0.0
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=2e-6, rtol=1e-5, err_msg=k)
        moved = max(moved, float(np.abs(ref[k] - port_g2p.flatten(params)[k]).max()))
    assert moved > 1e-4  # the second update moved the parameters


def test_saved_weights_read_by_both_packages(tmp_path):
    """A short CPU run of the CLI: the .npz it saves decodes words the same
    through the port's and the JAX package's ``neural_g2p``, and the held-out
    sets land beside it."""
    out = str(tmp_path / "w" / "g2p_weights.npz")
    report = train_g2p.main(["--out", out, "--device", "cpu", "--epochs", "1", "--batch", "16",
                             "--limit", "32"])
    assert report["steps"] == 2 and np.isfinite(report["loss"])
    assert os.path.isfile(tmp_path / "w" / "g2p_heldout.txt")
    assert os.path.isfile(tmp_path / "w" / "g2p_gold_heldout.txt")
    ours, ref = port_g2p.NeuralG2P(out), jax_g2p.NeuralG2P(out)
    for word in ("hello", "okonkwo", "reykjavik", "quinoa", "thessaloniki", "a"):
        assert ours(word) == ref(word)


def test_expand_lexicon_writes_the_jax_tools_file(tmp_path):
    ours, ref = str(tmp_path / "ours.txt"), str(tmp_path / "ref.txt")
    expand_lexicon.main(["--out", ours])
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "expand_lexicon.py"), "--out", ref],
                   check=True, capture_output=True, cwd=REPO)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_expand_lexicon_requires_out():
    with pytest.raises(SystemExit):
        expand_lexicon.main([])


def test_lexicon_coverage_prints_the_jax_tools_line(tmp_path, capsys):
    tool = _tool("lexicon_coverage")
    text_path = tmp_path / "t.txt"
    text_path.write_text("Zbigniew walked 42 quixotic miles to Tuesday's rehearsal, "
                         "humming softly; the reindeer didn't mind.\n", encoding="utf-8")
    for argv, text in (([], tool.SAMPLE), ([str(text_path)], text_path.read_text(encoding="utf-8"))):
        lexicon_coverage.main(argv)
        line = capsys.readouterr().out.strip()
        assert line == json.dumps(tool.coverage(text))


def test_train_g2p_asks_for_the_card_first(tmp_path):
    """Without ``--device cpu`` the tool asks for the card before it reads
    the lexicons, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_g2p.main(["--out", str(tmp_path / "w.npz")])
    assert not os.path.exists(tmp_path / "w.npz")
