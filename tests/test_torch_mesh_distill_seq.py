"""One distillation step, unguided and guided (w 1.5), on (seq 2) with
Ulysses and with the ring, and through the GPipe trunk on (pipe 2, nm 2)
(the teacher's stage too), against the JAX step under the same JAX mesh
and against the port's one-rank step, on the CPU. The cases, inputs and
bars are those of ``test_torch_mesh_distill.py`` (its module docstring);
the pipe mesh's global batch is four rows of different frame blocks.
"""
import pytest

from test_torch_mesh_distill import BLOCKS4, check_distill_step


@pytest.mark.parametrize("guidance", [None, 1.5], ids=["plain", "guided"])
@pytest.mark.parametrize("sp", ["ulysses", "ring"])
def test_distill_seq_mesh_step_matches_jax_and_one_rank(tmp_path, sp,
                                                        guidance):
    check_distill_step(tmp_path, (1, 2, 1, False), guidance, sp=sp)


@pytest.mark.parametrize("guidance", [None, 1.5], ids=["plain", "guided"])
def test_distill_pipe_mesh_step_matches_jax_and_one_rank(tmp_path,
                                                         guidance):
    check_distill_step(tmp_path, (1, 1, 1, False, 2), guidance,
                       num_micro=2, blocks=BLOCKS4)
