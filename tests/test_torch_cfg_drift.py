"""The port's ``video_gpt_tpu_torch/scripts/cfg_drift.py`` against the JAX
package's ``scripts/cfg_drift.py`` on the CPU.

- ``parse_schedule`` and ``DEFAULT_SWEEP``: the same sweep, and for each of
  its schedules the same ``SchedulerConfig`` fields and ``step_kinds``.
- The drift sweep at ``ModelConfig.tiny()`` in fp32 over a small geometry
  (2 conditioning frames, a 3-frame clip, 32x48), the JAX weights (random,
  head re-rolled) carried by ``videogpt_state_dict_from_jax``, against a
  recomposition of the JAX script's ``run`` from the JAX
  ``sample_separate_cfg``, ``VideoGPT.prefill`` and ``.decode``: each
  schedule's final latents within relative MSE 1e-5 of the JAX ones (the
  serving bar), its ``rel_final_latent_mse`` within 1e-6 absolute, and
  the same ``steps_guided``, ``uncond_evals`` and ``kinds``.
- ``rel_cost`` is the JAX formula with the ratio it is given.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_gpt_tpu.config import ModelConfig as JModelConfig
from video_gpt_tpu.layout import (frame_block_inference_layout,
                                  tokens_per_frame)
from video_gpt_tpu.models.video_gpt import Batch as JBatch
from video_gpt_tpu.models.video_gpt import VideoGPT as JVideoGPT
from video_gpt_tpu.models.video_gpt import decode_mask as jdecode_mask
from video_gpt_tpu.sampling import scheduler as jscheduler
from video_gpt_tpu_torch.config import ModelConfig
from video_gpt_tpu_torch.models.video_gpt import VideoGPT
from video_gpt_tpu_torch.sampling.scheduler import step_kinds
from video_gpt_tpu_torch.scripts import cfg_drift
from video_gpt_tpu_torch.utils.weights import videogpt_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLEAN, N_GEN, H, W = 2, 3, 32, 48
# one schedule of each kind of the sweep: intervals, uncond refresh with
# and without one, fewer and shifted steps
SUBSET = ("ival=0.15:0.7;ival=0.0:0.75;ival=0.15:0.7,k=2;k=3;steps=8;"
          "steps=6,shift=1.5,ival=0.15:0.7;steps=5,k=2")


@pytest.fixture(scope="module")
def jax_script(monkeypatch_module):
    """The JAX script as a module, with its XLA compile cache left off (it
    would write a cache outside the repository)."""
    from video_gpt_tpu.utils import cache
    monkeypatch_module.setattr(cache, "enable_compilation_cache",
                               lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_cfg_drift", os.path.join(REPO, "scripts", "cfg_drift.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_sweep_and_schedules_match_the_jax_script(jax_script):
    assert cfg_drift.DEFAULT_SWEEP == jax_script.DEFAULT_SWEEP
    assert cfg_drift.STEPS == jax_script.STEPS
    assert cfg_drift.NUM_LAYERS == jax_script.NUM_LAYERS
    for spec in cfg_drift.DEFAULT_SWEEP.split(";") + ["ival=none,k=1", ""]:
        got, want = cfg_drift.parse_schedule(spec), \
            jax_script.parse_schedule(spec)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), spec
        assert step_kinds(got) == jscheduler.step_kinds(want), spec
    with pytest.raises(ValueError, match="unknown schedule key"):
        cfg_drift.parse_schedule("steps=4,q=1")


def test_rel_cost_is_the_jax_formula_at_the_given_ratio(jax_script):
    """At the TPU's ratio 0.47 the port's cost is the JAX script's."""
    ref = torch.ones(2)
    for spec in cfg_drift.DEFAULT_SWEEP.split(";"):
        sched = cfg_drift.parse_schedule(spec)
        n_uncond = sum(k == "cfg" for k in step_kinds(sched))
        rec = cfg_drift.printed(cfg_drift.drift_record(
            spec, sched, ref, ref, 0.47))
        assert rec["rel_cost"] == round(
            (sched.num_steps + 0.47 * n_uncond) / (10 * 1.47), 4), spec
        assert rec["rel_final_latent_mse"] == 0.0


def _jax_run(model, params, batch_c, batch_u, tail, prefix, clean, z0):
    """The JAX script's ``run`` at the test's geometry."""
    def run(sched):
        @jax.jit
        def clip(params, clean, z0):
            cache = model.apply(params, batch_c, clean, prefix,
                                method=JVideoGPT.prefill)
            bias_c = jdecode_mask(batch_c.meta.tail(tail), batch_c.meta)
            bias_u = jdecode_mask(batch_u.meta, batch_u.meta)

            def denoise_cond(z, t):
                return model.apply(params, batch_c, z, t, cache, tail,
                                   bias_c, method=JVideoGPT.decode)

            def denoise_pair(z, t):
                return (denoise_cond(z, t),
                        model.apply(params, batch_u, z, t, bias=bias_u))

            return jscheduler.sample_separate_cfg(
                z0, denoise_pair, sched, cfg_scale=1.5,
                denoise_cond_fn=denoise_cond)

        return np.asarray(clip(params, clean, z0), np.float32)
    return run


def test_drift_matches_the_jax_recomposition(jax_script):
    jm = JVideoGPT(JModelConfig.tiny(), dtype=jnp.float32)
    n = tokens_per_frame(H, W)
    lay_c = frame_block_inference_layout(N_CLEAN, N_GEN, n, use_cfg=False)
    lay_u = frame_block_inference_layout(0, N_GEN, n, use_cfg=False)
    batch_c, batch_u = JBatch.from_layout(lay_c), JBatch.from_layout(lay_u)
    tail = lay_c.noisy_tail_len()
    prefix = lay_c.length - tail
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((N_GEN, H // 8, W // 8, 4)).astype(np.float32)
    clean = rng.standard_normal((N_CLEAN, H // 8, W // 8, 4)).astype(
        np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), batch_c,
                              jnp.asarray(z0), jnp.zeros((N_GEN,)),
                              jnp.asarray(clean))
    # the script's re-rolled head
    head = params["params"]["final_layer"]
    leaves, treedef = jax.tree.flatten(head)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params["params"]["final_layer"] = jax.tree.unflatten(treedef, [
        jax.random.normal(k, x.shape, x.dtype) * 0.05
        for k, x in zip(keys, leaves)])
    params = jax.device_get(params)
    jrun = _jax_run(jm, params, batch_c, batch_u, tail, prefix,
                    jnp.asarray(clean), jnp.asarray(z0))

    model = VideoGPT(ModelConfig.tiny()).eval()
    model.load_state_dict(videogpt_state_dict_from_jax(params, model.cfg),
                          strict=True)
    clip = cfg_drift.Clip.build(N_CLEAN, N_GEN, H, W, "cpu")
    assert (clip.tail, clip.prefix) == (tail, prefix)
    tclean, tz0 = torch.from_numpy(clean), torch.from_numpy(z0)

    full = jrun(jax_script.parse_schedule("ival=none"))
    denom = float(np.mean(full ** 2))
    port_ref = cfg_drift.final_latents(model, clip, tclean, tz0,
                                       cfg_drift.parse_schedule(""))
    assert float(((port_ref.numpy() - full) ** 2).mean()) / denom <= 1e-5
    records = []
    for spec in SUBSET.split(";"):
        sched = jax_script.parse_schedule(spec)
        out = jrun(sched)
        got = cfg_drift.final_latents(model, clip, tclean, tz0,
                                      cfg_drift.parse_schedule(spec))
        assert float(((got.numpy() - out) ** 2).mean()) / float(
            np.mean(out ** 2)) <= 1e-5, spec
        rec = cfg_drift.drift_record(spec, cfg_drift.parse_schedule(spec),
                                     got, port_ref, 0.5)
        records.append(rec)
        want = float(np.mean((out - full) ** 2)) / denom
        assert abs(rec["rel_final_latent_mse"] - want) <= 1e-6, (spec, rec,
                                                                 want)
        kinds = jscheduler.step_kinds(sched)
        assert rec["steps_guided"] == sum(k != "cond" for k in kinds)
        assert rec["uncond_evals"] == sum(k == "cfg" for k in kinds)
        assert rec["kinds"] == "".join(
            {"cfg": "G", "cfg_reuse": "r", "cond": "."}[k] for k in kinds)
    # a schedule that moves the trajectory shows it
    assert max(r["rel_final_latent_mse"] for r in records) > 0
    # the sweep: the reference schedule against itself drifts by nothing
    again = cfg_drift.sweep(model, clip, tclean, tz0, ["ival=none", " "],
                            0.5)
    assert len(again) == 1 and again[0]["rel_final_latent_mse"] == 0.0
    ratio = cfg_drift.uncond_over_cond(model, clip, tclean, tz0)
    assert ratio["uncond_over_cond"] > 0 and np.isfinite(
        ratio["uncond_over_cond"])
