"""P1, the overlap probe of the port, against the TPU probe's own bodies on
the CPU.

``scripts/overlap_probe.py`` is loaded as it is, with ``importlib``; its
call to ``enable_compilation_cache`` at import is made a no-op first, so
that it sets no persistent JAX cache for the rest of the worker. Its
``_serial_kernel`` and ``_pipelined_kernel`` (nsub 2, 4, 8, 16) run under
``pl.pallas_call(..., interpret=True)`` at the probe's own shape: 256
queries over 8192 keys of D 128, bf16. Both sides get the same bf16 draws,
``probe_inputs(1, "cpu")`` (a numpy seed); the port's ``overlap_serial``
and ``overlap_pipelined`` on CPU tensors are the plain version, the one
the card's kernels are held to.

Bar, per element: |got - want| <= 1e-5 + 2^-7 |want|. Both sides sum
fp32 products of the same bf16 operands in other orders and round p to
bf16 before P.V; the outputs (~1e-2: means of 8192 values of v) then round
to bf16, where values that differ by less than fp32's error can land one
bf16 step (at most 2^-7 |want|) apart; the 1e-5 covers a term whose
bf16(p) rounds the other way (2^-8 |v| / 8192) near a zero output.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import video_gpt_tpu.utils.cache as jcache
from video_gpt_tpu_torch.probes import overlap_probe

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "overlap_probe.py")
ATOL, RTOL = 1e-5, 2.0 ** -7


@pytest.fixture(scope="module")
def tpu_probe():
    """The TPU probe's module, loaded without enabling the JAX cache."""
    spec = importlib.util.spec_from_file_location("tpu_overlap_probe",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return overlap_probe.probe_inputs(1, "cpu")


def test_probe_shapes_match_the_tpu_probe(tpu_probe):
    assert (overlap_probe.BQ, overlap_probe.LK, overlap_probe.D) == (
        tpu_probe.BQ, tpu_probe.LK, tpu_probe.D)


@pytest.mark.parametrize("nsub", [None] + list(overlap_probe.NSUBS),
                         ids=["serial"] + [f"nsub{n}" for n in
                                           overlap_probe.NSUBS])
def test_probe_matches_the_tpu_bodies(tpu_probe, inputs, nsub):
    q, k, v = inputs
    kernel = (tpu_probe._serial_kernel if nsub is None else
              functools.partial(tpu_probe._pipelined_kernel, nsub=nsub))
    call = pl.pallas_call(
        kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct((overlap_probe.BQ, overlap_probe.D),
                                       jnp.bfloat16))
    jq, jk, jv = (jnp.asarray(x[0].float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    want = np.asarray(call(jq, jk, jv).astype(jnp.float32))
    got = (overlap_probe.overlap_serial(q, k, v) if nsub is None else
           overlap_probe.overlap_pipelined(q, k, v, nsub))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got = got[0].float().numpy()
    bar = ATOL + RTOL * np.abs(want)
    ratio = float((np.abs(got - want) / bar).max())
    print(f"P1 {'serial' if nsub is None else f'nsub {nsub}'}: max abs "
          f"{float(np.abs(got - want).max()):.2e}, worst error / bar "
          f"{ratio:.3f}")
    assert ratio <= 1.0
