"""One training step through the GPipe trunk over the pipe axis, on (pipe
2), (data 2, pipe 2) at 2 microbatches, (data 2, pipe 2, zero3), and a
pipe step under gradient accumulation, against the JAX step under the
same JAX mesh (``make_train_step`` with ``apply_fn=pp_apply`` on
``place_train_state(pp=True)``) and against the port's one-rank step, on
the CPU. The global batch is four rows of different frame blocks (each
data rank holds whole microbatches). The cases, inputs and bars are
those of ``test_torch_mesh_train_step.py`` (its module docstring): loss
rtol 1e-5, every gradient and updated parameter rtol 1e-4 / atol 1e-6,
each rank's part (its stage's layers, and everything outside the trunk)
against the same part of the whole.
"""
import pytest

from test_torch_mesh_train_step import check_mesh_step

BLOCKS4 = ((1, 2), (1, 1, 1), (2, 1), (3,))


@pytest.mark.parametrize("mesh_dims,num_micro", [
    ((1, 1, 1, False, 2), 0), ((2, 1, 1, False, 2), 2),
    ((2, 1, 1, True, 2), 2)], ids=["pipe2", "data2_pipe2_nm2",
                                   "data2_pipe2_zero3"])
def test_pipe_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_dims,
                                                 num_micro):
    check_mesh_step(tmp_path, None, mesh_dims, num_micro=num_micro,
                    blocks=BLOCKS4)


def test_pipe_gradient_accumulation(tmp_path):
    """``gradient_accumulation_steps=2`` on (data 2, pipe 2): each
    micro-step's stage gradients reduced over data, the running mean
    updated once per cycle, against the JAX mesh's two steps."""
    check_mesh_step(tmp_path, None, (2, 1, 1, False, 2), num_micro=2,
                    blocks=BLOCKS4, accum=2, seeds=(7, 8))
