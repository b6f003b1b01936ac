"""The import guard: no run holds JAX or the JAX package, compared by whole
top-level names, and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

import pytest

from bench_port.harness import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_gpt_tpu_torch_probe", object())
    assert "video_gpt_tpu" not in core.forbidden_modules()
    for name in ("jax", "jaxlib.xla", "flax.linen", "video_gpt_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert core.forbidden_modules() == ["flax", "jax", "jaxlib",
                                        "video_gpt_tpu"]
    with pytest.raises(core.RunError):
        core.guard_imports("in a test")


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "harness", "drivers",
                                    "metrics", ""])
def test_no_source_imports_jax(folder):
    root = os.path.join(BENCH, folder)
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in imported(os.path.join(root, name))}
            assert not tops & set(core.FORBIDDEN), (name, tops)


def test_reference_imports_nothing_of_the_program():
    root = os.path.join(BENCH, "reference")
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in imported(os.path.join(root, name))}
            assert "video_gpt_tpu_torch" not in tops, name
    code = ("import sys; import bench_port.reference.model, "
            "bench_port.reference.serve, bench_port.reference.train, "
            "bench_port.reference.image_layout, bench_port.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'video_gpt_tpu', "
            "'video_gpt_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(BENCH), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """``run.py`` exits non-zero and prints no result line without CUDA,
    and in a folder that holds the benchmark alone."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"),
                tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "videogpt.serve_clip", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
