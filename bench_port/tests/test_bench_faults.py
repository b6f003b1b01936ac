"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, each cell run tiny on the CPU with one
fault planted in the program, against the cells' own limits. The faults
are the ones each cell can have on one card: a training step that leaves
its state unchanged, half of the batch left out with the mean taken over
the rest (B 2), and a served answer altered where it is produced."""
import pytest

from bench_port.tests import tiny_tree

UNCHANGED = """
from video_gpt_tpu_torch.training import train_state
def _step(self):
    grads = self._grads()
    norm = self._norm(grads)
    self._clear_grads()
    return norm
train_state.AdamW.step = _step
"""

HALF_BATCH = """
from video_gpt_tpu_torch.training import train_state
_loss = train_state.training_loss
def _half(model, inputs, draws, **kw):
    loss, aux = _loss(model, inputs, draws, **kw)
    rows = inputs.batch.input_ids.shape[0]
    keep = inputs.noisy_frame_row < rows // 2
    return aux["per_frame_loss"][keep].mean(), aux
train_state.training_loss = _half
"""

ALTERED = """
from video_gpt_tpu_torch.sampling import pipeline
_denoise = pipeline.VideoGPTPipeline._denoise
def _altered(self, *a, **kw):
    z = _denoise(self, *a, **kw)
    return z.index_fill(0, z.new_zeros(1, dtype=int), 0.0)
pipeline.VideoGPTPipeline._denoise = _altered
"""


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_tree.make(str(tmp_path_factory.mktemp("faults")))


@pytest.mark.parametrize("workload, patch", [
    ("videogpt.train_stage4", UNCHANGED),
    ("videogpt.train_stage1", UNCHANGED),
    ("omnigen.train_image", UNCHANGED),
    ("omnigen.train_image", HALF_BATCH),
    ("videogpt.serve_clip", ALTERED),
], ids=["stage4-unchanged", "stage1-unchanged", "image-unchanged", "image-half-batch",
        "serve-altered"])
def test_fault_is_not_correct(bench, workload, patch):
    out = tiny_tree.run_cell(bench, workload, seed=3000000023, patch=patch)
    assert out["correct"] is False, out["check"]
