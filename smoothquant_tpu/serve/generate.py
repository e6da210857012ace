"""Generation: jitted prefill + decode-step over a static KV cache.

Capability the reference inherits from HF but never exercises (SURVEY.md §5
"also absent"); here it is first-class, quantization-aware (the ForwardContext
threads the simulated or real quant path), and mesh-shardable (params may be
device_put with parallel.param_specs before building the engine).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.models.common import ForwardContext, KVCache, QuantKVCache


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    eos_token_id: Optional[int] = None
    seed: int = 0


def sample_token(logits: jax.Array, temperature: float, key) -> jax.Array:
    """logits (B, V) → token ids (B,). temperature 0 = argmax."""
    if temperature <= 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return jax.random.categorical(key, logits / temperature, axis=-1).astype(jnp.int32)


class Generator:
    """Single-sequence/batch generation on top of a model module.

    model_mod: models.llama / models.opt (needs forward(params, ids, cfg,
    ctx, caches) and cfg.num_hidden_layers etc.).
    """

    def __init__(self, model_mod, params, cfg, quant=None,
                 kv_dtype=None, max_len: int = 2048, quant_kv: bool = False,
                 compute: str = "auto", interpret: bool = False,
                 prefill_params=None, forward_fn=None):
        """prefill_params: optional second params tree used ONLY for prompt
        prefill — e.g. kernels.pack.promote_model_int8(params), whose
        single-group int8 layout runs full-depth int8 GEMMs
        (prefill-optimal) while decode keeps the 4-bit nibble tree
        (bandwidth-optimal).

        forward_fn: optional replacement for mod.forward with signature
        (params, ids, caches) -> (logits, caches) — e.g. the shard_map step
        from parallel.tp_packed.make_tp_decode_v2, which makes this
        Generator serve a tensor-parallel model over a head-sharded KV
        cache."""
        self.mod = model_mod
        self.params = params
        self.prefill_params = params if prefill_params is None else prefill_params
        self.cfg = cfg
        self.ctx = ForwardContext(quant=quant, compute=compute,
                                  interpret=interpret)
        self.max_len = max_len
        self.kv_dtype = kv_dtype or jnp.dtype(cfg.dtype)
        self._cache_cls = QuantKVCache if quant_kv else KVCache
        n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        self._n_kv = n_kv

        if forward_fn is None:
            def forward_fn(params, ids, caches):
                return self.mod.forward(params, ids, self.cfg, ctx=self.ctx,
                                        caches=caches)

        @functools.partial(jax.jit, static_argnames=("temperature",))
        def _prefill(params, ids, caches, key, temperature):
            logits, caches = forward_fn(params, ids, caches)
            nxt = sample_token(logits[:, -1, :], temperature, key)
            return nxt, caches

        # sampling happens ON DEVICE and only the (B,) token ids cross the
        # host boundary per step — fetching (B, V) float logits every token
        # was the serving loop's dominant host<->device traffic
        @functools.partial(jax.jit, static_argnames=("temperature",))
        def _decode(params, tok, caches, key, temperature):
            logits, caches = forward_fn(params, tok[:, None], caches)
            nxt = sample_token(logits[:, -1, :], temperature, key)
            return nxt, caches

        self._prefill, self._decode = _prefill, _decode

    def _new_caches(self, batch: int):
        return [
            self._cache_cls.create(batch, self.max_len, self._n_kv,
                                   self.cfg.head_dim, self.kv_dtype)
            for _ in range(self.cfg.num_hidden_layers)
        ]

    def generate(self, prompt_ids: np.ndarray, gen: GenerationConfig) -> np.ndarray:
        """prompt_ids (B, S) → (B, S + new) generated ids (greedy/temperature)."""
        prompt_ids = np.atleast_2d(np.asarray(prompt_ids))
        b, s = prompt_ids.shape
        if s + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({s}) + max_new_tokens({gen.max_new_tokens}) exceeds "
                f"max_len({self.max_len})"
            )
        caches = self._new_caches(b)
        key = jax.random.PRNGKey(gen.seed)

        key, sub = jax.random.split(key)
        tok, caches = self._prefill(self.prefill_params,
                                    jnp.asarray(prompt_ids), caches, sub,
                                    gen.temperature)
        out = [prompt_ids]
        done = np.zeros(b, bool)
        for step in range(gen.max_new_tokens):
            tok_np = np.asarray(tok)
            if gen.eos_token_id is not None:
                tok_np = np.where(done, gen.eos_token_id, tok_np)
                done |= tok_np == gen.eos_token_id
            out.append(tok_np[:, None])
            if step + 1 == gen.max_new_tokens or (
                    gen.eos_token_id is not None and done.all()):
                break
            key, sub = jax.random.split(key)
            tok, caches = self._decode(self.params, jnp.asarray(tok_np),
                                       caches, sub, gen.temperature)
        return np.concatenate(out, axis=1)
