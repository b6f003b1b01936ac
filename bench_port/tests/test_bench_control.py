"""The control: the reference one precision below the configuration's, in
the program's place. On the CPU at a tiny size it has to read above the
sound program's numbers; on the card at the cells' own size
(``-m gpu``) it has to fail one of each cell's limits on three seeds."""
import os

import pytest
import torch

from bench_port.tests import tiny_tree

CELLS = ["videogpt.serve_clip", "videogpt.train_stage4",
         "videogpt.train_stage1"]


def worst_ratio(numbers, limits):
    return max(numbers[k] / limits[k] for k in limits)


@pytest.mark.parametrize("workload", CELLS + ["omnigen.train_image"])
def test_control_reads_above_the_program(tmp_path, workload):
    from bench_port.control import control
    bench = tiny_tree.make(str(tmp_path))
    limits = tiny_tree.read(os.path.join(
        bench, "workloads", f"{workload}.json"))["check"]["limits"]
    seed = 3000000029
    sound = tiny_tree.run_cell(bench, workload, seed=seed)
    got = {k: v["value"] for k, v in sound["check"].items()}
    ctl = control(bench, workload, [seed], torch.device("cpu"))[0]
    assert worst_ratio(ctl["readings"]["fp8"], limits) > worst_ratio(
        got, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    from bench_port.control import BENCH_DIR, control
    limits = tiny_tree.read(os.path.join(
        BENCH_DIR, "workloads", f"{workload}.json"))["check"]["limits"]
    seeds = [3000000031, 3000000037, 3000000041]
    for line in control(BENCH_DIR, workload, seeds, torch.device("cuda")):
        assert worst_ratio(line["readings"]["fp8"], limits) > 1.0, line
