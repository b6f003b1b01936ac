"""A copy of the benchmark's tree at a size a CPU test can run: the same
files, the configurations cut to a 2-layer, 64-wide trunk and a narrow VAE,
the cells to a few small frames. The limits of the comparison are the
cells' own. The OmniGen fine-tuning driver, which no cell of the benchmark
runs yet, gets a cell of its own here (``IMAGE_CELL``), so that its path is
tested as a cell would run it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=128,
                  pos_embed_max_size=16)
TINY_VAE = dict(block_out_channels=[8, 8, 16, 16], layers_per_block=1,
                norm_num_groups=4)
TINY_TRAFFIC = {
    "videogpt.serve_clip": dict(height=32, width=48, n_clean=2,
                                gen_nums=[2], steps=2, window=4),
    "videogpt.train_stage4": dict(frames=4, height=32, width=48,
                                  frame_blocks=[1, 2, 1]),
    "videogpt.train_stage1": dict(frames=4, height=32, width=48,
                                  frame_blocks=[1, 1, 1, 1]),
}
IMAGE_CELL = {
    "config": "omnigen-phi3mini", "driver": "train_image", "chips": 1,
    "why": "the OmniGen fine-tuning driver at a tiny size",
    "traffic": {
        "rows": 2, "output_size": [32, 32], "input_size": [32, 32],
        "max_input_images": 3, "prompts": [[3, 2], [5, 1]], "pad_to": 48,
        "mixed_precision": "bf16",
        "optimizer": {"lr": 1e-4, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
                      "weight_decay": 0.1, "max_grad_norm": 1.0,
                      "input_noise": 0.9}},
    "trace_units": 2,
    "check": {"reference_precision": "bf16", "steps": 3, "moments": "device",
              "limits": {"loss_gap": 0.006, "grad_gap": 0.0045,
                         "change_gap": 0.03}},
}


def read(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(dst: str) -> str:
    """The tiny tree under ``dst``; returns its ``bench_port`` folder."""
    bench = os.path.join(dst, "bench_port")
    shutil.copytree(os.path.join(REPO, "bench_port"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "video_gpt_tpu_torch"),
               os.path.join(dst, "video_gpt_tpu_torch"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        c = read(path)
        c["model"].update(TINY_MODEL)
        c["vae"].update(TINY_VAE)
        write(path, c)
    for name, traffic in TINY_TRAFFIC.items():
        path = os.path.join(bench, "workloads", f"{name}.json")
        w = read(path)
        w["traffic"].update(traffic)
        write(path, w)
    write(os.path.join(bench, "workloads", "omnigen.train_image.json"),
          IMAGE_CELL)
    path = os.path.join(dst, "BENCHMARK.json")
    b = read(path)
    b["configs"].append({"name": "omnigen-phi3mini", "source": "a test",
                         "file": "bench_port/configs/omnigen-phi3mini.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "omnigen.train_image",
                           "config": "omnigen-phi3mini",
                           "traffic": "train_image", "chips": 1,
                           "why": IMAGE_CELL["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "videogpt.train_stage1" in m.get("workloads", ()):
            m["workloads"].append("omnigen.train_image")
    write(path, b)
    return bench


RUNNER = """
import json, sys, time
t = time.time()
sys.path.insert(0, {root!r})
{patch}
from bench_port.harness import core
print(json.dumps(core.run(sys.argv[1:], {bench!r}, t, require_cuda=False)))
"""


def run_cell(bench: str, workload: str, seed: int = 7, seconds: float = 0.5,
             trace: int = 0, patch: str = "") -> dict:
    """One CPU run of ``workload`` in a fresh process (``patch``: Python
    run first, a fault planted in the program); returns the last line of
    its standard output, parsed."""
    root = os.path.dirname(bench)
    code = RUNNER.format(root=root, bench=bench, patch=patch)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", code, "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
