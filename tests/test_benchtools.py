"""Timing helpers, the device peak table and the compile-cache location."""

import os

import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.utils import benchtools, roofline


def test_time_calls_waits_and_returns_seconds():
    f = jax.jit(lambda x: x @ x)
    t = benchtools.time_calls(f, (jnp.ones((64, 64)),), iters=3, warmup=1)
    assert 0.0 < t < 10.0


def test_time_stateful_threads_the_state():
    step = jax.jit(lambda c: c + 1)
    t, state = benchtools.time_stateful(step, jnp.zeros(()), iters=5,
                                        warmup=2)
    assert t > 0.0 and float(state) == 7.0


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError, match="no peak table"):
        roofline.chip_spec("NVIDIA A100-SXM4-80GB")
    assert roofline.chip_spec("NVIDIA H100 80GB HBM3").hbm_bw == 3.35e12


@pytest.mark.parametrize("nbytes,ops,kind", [
    (1e9, 0.0, "bytes"), (1e3, 1e15, "int8")])
def test_bound_names_the_limit(nbytes, ops, kind):
    chip = roofline.chip_spec("NVIDIA H100")
    t, which = roofline.bound_seconds(chip, nbytes=nbytes, int8_ops=ops)
    assert which == kind and t > 0.0


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    try:
        assert benchtools.enable_compile_cache("/checkout") == str(
            tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == before  # not set
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = benchtools.enable_compile_cache(str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
