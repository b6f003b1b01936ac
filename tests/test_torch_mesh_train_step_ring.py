"""One training step with the ring over the seq axis (K6/K7 per chunk,
merged by the global logsumexp), on (seq 2), (data 2, seq 2) and (seq 2,
tensor 2), against the JAX step under the same JAX mesh with
``sp_attention='ring'`` and against the port's one-rank step, on the CPU;
and one ``ImageGenTrainer`` step with the ring on (seq 2). The cases,
inputs and bars are those of ``test_torch_mesh_train_step.py`` (its module
docstring): loss rtol 1e-5, every gradient and updated parameter rtol
1e-4 / atol 1e-6, each rank's part against the same part of the whole.
"""
import pytest

from test_torch_mesh_train_step import check_mesh_step


@pytest.mark.parametrize("mesh_dims", [(1, 2, 1, False), (2, 2, 1, False),
                                       (1, 2, 2, False)],
                         ids=["seq2", "data2_seq2", "seq2_tensor2"])
def test_ring_mesh_step_matches_jax_and_one_rank(tmp_path, mesh_dims):
    check_mesh_step(tmp_path, None, mesh_dims, sp="ring")


def test_image_trainer_step_with_the_ring(tmp_path):
    """One ``ImageGenTrainer`` step on (seq 2) with ``sp_attention='ring'``
    (the trainer sets the model's attention from it): the trainer's own
    step against the one-rank trainer's, and the train step on injected
    latents and draws against the one-rank step."""
    import dataclasses
    import numpy as np
    import torch_mesh_ranks as ranks
    from test_torch_mesh_train_step import (CFG, PX, _compare, _setup,
                                            _tcfg)
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.data import image_text as tdata
    from video_gpt_tpu_torch.image_gen import TextRow
    from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
    _, sd, vae_sd, _ = _setup()
    rng = np.random.default_rng(3)
    pixels = [rng.uniform(-1, 1, (PX, PX, 3)).astype(np.float32)
              for _ in range(3)]
    samples = [tdata.ImageGenSample(TextRow([5, 6] + [0] * 4 + [7],
                                            [(2, 6)]), [pixels[0]],
                                    pixels[1]),
               tdata.ImageGenSample(TextRow([8, 9, 10], []), [], pixels[2])]
    tcfg = dataclasses.replace(_tcfg()[1], sp_attention="ring")
    args = (CFG, tcfg, sd, vae_sd, samples, PX, 40)
    one = ranks.image_step_case(None, *args)
    mesh_dims = (1, 2, 1, False)
    res = spawn_ranks(ranks.image_step_case, (MeshConfig(*mesh_dims),)
                      + args, 2, str(tmp_path), threads=1, timeout=300)
    assert all(r["ring"] for r in res)
    for r in res:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                   rtol=1e-5)
        _compare(r, one["grads"], one["params"], mesh_dims, r["coords"],
                 "image Trainer step with the ring vs one rank")
