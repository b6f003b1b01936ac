"""One training step on the meshes with a seq axis (Ulysses: K6/K7's
route on the card), and gradient accumulation on a mesh, against the JAX
step under the same JAX mesh and the port's one-rank step, on the CPU.
The cases, inputs and bars are those of ``test_torch_mesh_train_step.py``
(its module docstring); the files split the cases for the suite's
workers."""
import pytest

from test_torch_mesh_train_step import (check_gradient_accumulation,
                                        check_mesh_step)


@pytest.mark.parametrize("mesh_name", ["seq2", "data2_seq2", "seq2_tensor2"])
def test_seq_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_name):
    check_mesh_step(tmp_path, mesh_name)


def test_gradient_accumulation_on_a_mesh(tmp_path):
    """``gradient_accumulation_steps=2`` on (data 2): each micro-step's
    gradient reduced, the running mean updated once per cycle as optax
    ``MultiSteps`` averages, against the JAX mesh's two steps."""
    check_gradient_accumulation(tmp_path)


def test_input_head_step_on_a_data_mesh(tmp_path):
    """The aux input head on (data 2): the rows hold different numbers of
    clean frames, so each rank's loss takes the global batch's
    denominator (n noisy + n clean) and the mean over the data ranks is
    the global loss; the model's random weights are drawn for the whole
    model a parameter at a time on every rank (``init_random_(whole=,
    part=)``). Loss, every gradient and updated parameter against the
    one-rank Trainer step."""
    import dataclasses
    import numpy as np
    import torch_mesh_ranks as ranks
    from test_torch_mesh_train_step import (CFG, MESHES, PX, _compare,
                                            _setup, _tcfg)
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.models.vae import VAEConfig
    from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
    _, _, vae_sd, samples = _setup()
    tcfg = dataclasses.replace(_tcfg()[1], input_output_return=True)
    args = (CFG, tcfg, VAEConfig.tiny(), None, vae_sd, samples, (PX, PX))
    one = ranks.train_step_case(None, *args)
    mesh_dims = MESHES["data2"]
    res = spawn_ranks(ranks.train_step_case, (MeshConfig(*mesh_dims),)
                      + args, 2, str(tmp_path), threads=1, timeout=300)
    assert "input_final_layer.weight" in one["trainer"]["grads"]
    for r in res:
        np.testing.assert_allclose(r["trainer"]["loss"],
                                   one["trainer"]["loss"], rtol=1e-5)
        _compare(r["trainer"], one["trainer"]["grads"],
                 one["trainer"]["params"], mesh_dims, r["coords"],
                 "input-head step vs one rank")
