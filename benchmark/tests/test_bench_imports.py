"""What a run may load: the port, and neither JAX nor the JAX package,
compared by whole top-level names; the reference loads nothing of the
port."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness


def test_forbidden_names_are_compared_whole():
    mods = ["seismic_bpmf_tpu_torch", "seismic_bpmf_tpu_torch.ops.mf",
            "jaxtyping", "flaxen", "benchmark.harness", "numpy"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "seismic_bpmf_tpu", "seismic_bpmf_tpu.ops"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_program(root):
    ref = os.path.join(root, "benchmark", "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            for name in _imports(os.path.join(ref, fn)):
                top = name.lstrip(".").split(".", 1)[0]
                assert top not in ("jax", "jaxlib", "flax", "seismic_bpmf_tpu",
                                   "seismic_bpmf_tpu_torch"), (fn, name)
                assert not name.startswith(".."), (fn, name)
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.reference.mf, benchmark.reference.bp; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('seismic_bpmf_tpu') "
            "or m.split('.')[0] in ('jax', 'flax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_nothing_of_the_benchmark_imports_jax(root):
    for dirpath, _, files in os.walk(os.path.join(root, "benchmark")):
        for fn in files:
            if fn.endswith(".py"):
                for name in _imports(os.path.join(dirpath, fn)):
                    top = name.split(".", 1)[0]
                    assert top not in ("jax", "jaxlib", "flax",
                                       "seismic_bpmf_tpu"), (fn, name)


def test_a_run_without_the_program_or_card_prints_no_result(root, tmp_path):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    cell = bench["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True)
    assert out.returncode != 0
    assert not out.stdout.strip()
