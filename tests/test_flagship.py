"""utils/flagship.py: the flagship recipe and its random-weight build."""

import dataclasses

import jax
import numpy as np

from smoothquant_tpu.kernels.pack import PackedLinear
from smoothquant_tpu.models import ForwardContext, llama
from smoothquant_tpu.utils import flagship


def test_recipes_are_the_flagship():
    body, head = flagship.recipes()
    assert (body.weight_quant, body.act_quant) == ("per_group", "per_group")
    assert body.quant_bits == 4 and body.effective_act_bits == 4
    assert body.group_size == 64 and body.salient_prop == 0.05
    assert body.scale_dtype == "bfloat16"
    assert (head.weight_quant, head.act_quant, head.quant_bits) == (
        "per_channel", "per_token", 8)


def test_random_stats_cover_every_input_with_outliers():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    stats = flagship.random_stats(cfg, np.random.default_rng(0))
    keys = [key for _, key, _ in llama.quantizable_linears(cfg)]
    assert sorted(stats) == sorted(keys)
    for key, v in stats.items():
        width = (cfg.intermediate_size if "down_proj" in key
                 else cfg.hidden_size)
        assert v.shape == (width,)
        # 1 % of the channels (at least one) carry a ×20 outlier
        assert (v > 1.0).sum() == max(1, width // 100)
    again = flagship.random_stats(cfg, np.random.default_rng(0))
    assert all(np.array_equal(stats[k], again[k]) for k in stats)


def test_build_packed_gives_the_flagship_layout_and_runs():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    body, head = flagship.recipes()
    packed, stats, kept = flagship.build_packed(cfg, body, head, seed=1,
                                                keep_layers=1)
    assert list(kept["layers"]) == ["0"]
    lin = packed["layers"]["0"]["self_attn"]["qkv_proj"]
    assert isinstance(lin, PackedLinear) and lin.meta.nibble
    assert packed["layers"]["0"]["self_attn"]["o_proj"].meta.layout == (
        "identity")
    assert isinstance(packed["lm_head"], PackedLinear)
    assert packed["lm_head"].meta.act_bits == 8
    ids = jax.numpy.asarray(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 8)))
    logits, _ = llama.forward(packed, ids, cfg,
                              ctx=ForwardContext(quant=body))
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()
