"""The post step's guidance opt-ins against the JAX package on the CPU:
``fused_guidance_cfg=False`` and ``guidance_reuse_cfg_uncond`` (with zero
and with random CLIP embeddings), on the tiny UNet and inputs of
tests/test_torch_optins.py, with its tolerances: port against JAX 1e-4
absolute and relative; against the port's default step JAX's own bound,
rtol 1e-3, atol 1e-5.
"""
import numpy as np
import pytest

from test_torch_optins import (TOL, VARIANT_TOL, _inputs, _port,  # noqa: F401
                               _run, unets)


def test_unfused_guidance_cfg_matches_jax(unets):
    """fused_guidance_cfg=False (a batch-1 guidance and a batch-2 CFG
    forward a direction) against JAX's, and against the port's fused
    step."""
    args = _inputs(62)
    got, want = _run(unets, args, fused_guidance_cfg=False)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _port(unets, args), **VARIANT_TOL)


@pytest.mark.parametrize("zero_clip", [True, False])
def test_guidance_reuse_cfg_uncond_matches_jax(unets, zero_clip):
    """The batch-2 reuse step against JAX's. With zero CLIP embeddings the
    time-context quirk is inert and it equals the default step (JAX's
    identity); with random ones it differs and stays finite."""
    args = _inputs(63, zero_clip)
    got, want = _run(unets, args, guidance_reuse_cfg_uncond=True)
    np.testing.assert_allclose(got, want, **TOL)
    default = _port(unets, args)
    assert np.isfinite(got).all()
    if zero_clip:
        np.testing.assert_allclose(got, default, **VARIANT_TOL)
    else:
        assert np.abs(got - default).max() > 1e-6
