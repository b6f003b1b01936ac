"""The AFMoE cell (``videogpt-trinitymini.train_stage4``) at a tiny size on
the CPU through the data-driven tree: its driver runs to a correct result
line, a fault planted in the program (the window dropped, the shared
expert dropped) comes out not correct, and its reference imports neither
JAX nor the program. The yardstick's pairs agree with ``flops.py``'s where
there is no window."""
import os
import subprocess
import sys

import pytest

from bench_port import flops, flops_afmoe
from bench_port.reference.layout import RowSpec, build_layout
from bench_port.tests import tiny_tree

CELL = "videogpt-trinitymini.train_stage4"
# a dense layer and four expert layers (one of them full), 8 experts top-2
# of width 32, 4 heads of 32 over 2 KV heads, a window of about two frames
TINY_AFMOE = dict(num_hidden_layers=5, num_key_value_heads=2, head_dim=32,
                  intermediate_size=96, moe_intermediate_size=32,
                  num_experts=8, num_experts_per_tok=2, num_dense_layers=1,
                  sliding_window=16)

NO_WINDOW = """
from video_gpt_tpu_torch.models import afmoe, video_gpt
_attend, _biases = afmoe.attend, video_gpt.afmoe_biases
afmoe.attend = lambda *a, window=None, **kw: _attend(*a, **kw)
def _full(cfg, meta, pos):
    b = _biases(cfg, meta, pos)
    return None if b is None else afmoe.LayerBiases(b.full, b.full)
video_gpt.afmoe_biases = _full
"""

NO_SHARED = """
from video_gpt_tpu_torch.models import afmoe
def _routed_only(self, x):
    m = x.reshape(-1, x.shape[-1])
    w, idx = self.route(m)
    return afmoe.RoutedExperts.apply(
        m, w, idx, self.experts.gate_up_proj, self.experts.down_proj,
        self.counts).reshape(x.shape)
afmoe.AfmoeMoE.forward = _routed_only
"""


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    bench = tiny_tree.make(str(tmp_path_factory.mktemp("afmoe")))
    path = os.path.join(bench, "configs", "videogpt-trinitymini.json")
    cfg = tiny_tree.read(path)
    cfg["model"].update(TINY_AFMOE)
    tiny_tree.write(path, cfg)
    path = os.path.join(bench, "workloads", f"{CELL}.json")
    cell = tiny_tree.read(path)
    cell["traffic"].update(tiny_tree.TINY_TRAFFIC["videogpt.train_stage4"])
    tiny_tree.write(path, cell)
    return bench


def test_the_cell_runs_correct(bench):
    out = tiny_tree.run_cell(bench, CELL, seed=3000000029, trace=1)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert m["mfu.train"]["value"] > 0  # the host clock's
    for name in ("idle_share.train", "moe_roofline.train",
                 "window_attention_roofline.train"):
        assert name not in m  # no device trace on the CPU
    plain = tiny_tree.run_cell(bench, CELL, seed=3000000031)
    assert plain["correct"], plain["check"]
    assert {"train_tokens_per_s", "peak_mem_gib", "setup_s"} <= set(
        plain["metrics"])


@pytest.mark.parametrize("patch", [NO_WINDOW, NO_SHARED],
                         ids=["window-dropped", "shared-expert-dropped"])
def test_fault_is_not_correct(bench, patch):
    out = tiny_tree.run_cell(bench, CELL, seed=3000000037, patch=patch)
    assert out["correct"] is False, out["check"]


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import bench_port.reference.afmoe, "
            "bench_port.flops_afmoe; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'video_gpt_tpu', "
            "'video_gpt_tpu_torch'}))")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_window_pairs_agree_with_flops_without_a_window():
    lay = build_layout([RowSpec((1, 2, 1), "training"),
                        RowSpec((2, 2), "training")], 6)
    got = flops_afmoe.window_pairs(lay, 0)
    assert got["kernel"] == flops.pairs(lay, pad_rows=True)
    assert got["model"] == flops.pairs(lay, pad_rows=False)
    narrow = flops_afmoe.window_pairs(lay, 16)
    assert narrow["model"] < got["model"]
