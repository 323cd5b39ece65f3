"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level part, whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import os

from benchmark.harness import ROOT, forbidden_modules

BENCH = os.path.join(ROOT, "benchmark")
JAX_SIDE = {"jax", "jaxlib", "flax", "flamed_tts_tpu"}


def imported_tops(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = [(p, t) for p in sources(BENCH) for t in imported_tops(p) if t in JAX_SIDE]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p, t) for p in sources(os.path.join(BENCH, "reference")) for t in imported_tops(p)
           if t in JAX_SIDE | {"flamed_tts_tpu_torch"}]
    assert not bad


def test_the_run_guard_compares_whole_top_level_names():
    assert forbidden_modules(["flamed_tts_tpu_torch", "flamed_tts_tpu_torch.models", "jaxtyping",
                              "torch"]) == []
    assert forbidden_modules(["jax.numpy", "flamed_tts_tpu.ops", "flax"]) == [
        "flamed_tts_tpu.ops", "flax", "jax.numpy"]
