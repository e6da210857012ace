"""Tensor-parallel sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from smoothquant_tpu.models import ForwardContext, llama as jllama, opt as jopt
from smoothquant_tpu.models.registry import quantize_model
from smoothquant_tpu.parallel import (
    assert_group_shardable,
    make_mesh,
    param_specs,
    shard_params,
)
from smoothquant_tpu.quant import QuantConfig


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh(tp=4, dp=2)


def test_mesh_shape(mesh8):
    assert mesh8.shape == {"dp": 2, "tp": 4}


def test_llama_tp_forward_matches_single_device(mesh8):
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))

    ref, _ = jllama.forward(params, jnp.asarray(ids), cfg)

    specs = param_specs("llama", params)
    sharded = shard_params(params, specs, mesh8)
    fwd = jax.jit(lambda p, i: jllama.forward(p, i, cfg)[0])
    batch_sharding = NamedSharding(mesh8, P("dp", None))
    got = fwd(sharded, jax.device_put(jnp.asarray(ids), batch_sharding))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4, rtol=2e-3)


def test_llama_tp_quantized_forward_matches(mesh8):
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(1), cfg)
    qcfg = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8, quantize_bmm_input=True, salient_prop=0.05)
    feat = {
        f"model.layers.{i}.{g}.{p}": np.random.default_rng(i).uniform(
            0.1, 1.0, size=(cfg.intermediate_size if p == "down_proj" else cfg.hidden_size,))
        for i in range(cfg.num_hidden_layers)
        for g, ps in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                      ("mlp", ("gate_proj", "up_proj", "down_proj")))
        for p in ps
    }
    qparams = quantize_model("llama", params, cfg, qcfg, input_feat=feat)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 8))

    ctx = ForwardContext(quant=qcfg)
    ref, _ = jllama.forward(qparams, jnp.asarray(ids), cfg, ctx=ctx)

    specs = param_specs("llama", qparams)
    sharded = shard_params(qparams, specs, mesh8)
    fwd = jax.jit(lambda p, i: jllama.forward(p, i, cfg, ctx=ctx)[0])
    got = fwd(sharded, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4, rtol=2e-3)


def test_opt_tp_forward_matches(mesh8):
    cfg = jopt.OPTConfig.tiny()
    params = jopt.init_params(jax.random.PRNGKey(3), cfg)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 12))
    ref, _ = jopt.forward(params, jnp.asarray(ids), cfg)
    sharded = shard_params(params, param_specs("opt", params), mesh8)
    got = jax.jit(lambda p, i: jopt.forward(p, i, cfg)[0])(sharded, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4, rtol=2e-3)


def test_group_shardable_guard():
    assert_group_shardable(4096, 4, 128)  # 1024 per shard, 128 | 1024
    with pytest.raises(ValueError):
        assert_group_shardable(4096, 4, 768)
    with pytest.raises(ValueError):
        assert_group_shardable(100, 8, 4)


@pytest.mark.parametrize("kind", ["tp", "cp", "pp"])
def test_meshes_follow_device_order(kind):
    """GPUs of a host are joined all to all, so every mesh is laid out in
    jax.devices() order (no topology-driven reordering)."""
    from smoothquant_tpu.parallel.cp import make_cp_mesh
    from smoothquant_tpu.parallel.pp import make_pp_mesh

    devs = jax.devices()[:4]
    mesh = {"tp": lambda: make_mesh(tp=2, dp=2, devices=devs),
            "cp": lambda: make_cp_mesh(4, devices=devs),
            "pp": lambda: make_pp_mesh(4, devices=devs)}[kind]()
    assert list(mesh.devices.reshape(-1)) == devs
