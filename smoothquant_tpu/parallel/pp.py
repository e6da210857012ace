"""Pipeline parallelism: GPipe-style microbatched stages over a `pp` axis.

The reference's only "pipeline" is accelerate's `device_map` layer
placement — big-model memory spill with zero overlap (SURVEY.md §2.9,
reference ppl_eval.py:70).  Here pipelining is a real schedule: the layer
stack splits into `pp` contiguous stages (per-stage weights sharded over
the mesh axis — the dominant memory), the batch splits into M
microbatches, and a `lax.fori_loop` over M + pp - 1 ticks shifts
activations stage-to-stage with `jax.lax.ppermute` (one collective
permute per tick).  Bubble fraction is (pp-1)/(M+pp-1) — raise `microbatches`
to amortize.

SPMD shape: every device runs the same program; at tick t device s
computes microbatch (t - s) when 0 <= t-s < M and garbage otherwise
(masked out of the output buffer).  Embeddings/final-norm/lm_head are
replicated for program uniformity — per-layer weights dominate memory at
depth; a production deployment would fold them into stage 0 / stage pp-1.

Prefill (make_pp_forward) pipelines full-sequence microbatches — the same
unit the reference evaluates.  Decode (make_pp_decode, VERDICT r4 #7)
threads PER-STAGE KV caches through the tick loop: each device owns the
caches of its own layers (the dominant decode state, sharded with the
stage weights), a single-token step flows stage-to-stage over pp ticks
(microbatch = 1 — no intra-step overlap, correctness-first v1), and
inactive stages keep their caches via a masked select.  Compatible with
packed (real-kernel) params — stage weights are PackedLinears and run
the packed int4/int8 path per stage.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

PP_AXIS = "pp"


def make_pp_mesh(pp: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """1-D (pp,) mesh in jax.devices() order: the GPUs of a host are joined
    all to all by NVLink, so stage order needs no topology."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    pp = pp or len(devices)
    return Mesh(np.array(devices[:pp]), (PP_AXIS,))


def stack_pp_stages(params: dict, cfg, pp: int) -> dict:
    """Restack a per-layer params dict into per-STAGE stacks.

    Returns {"embed_tokens", "norm", "lm_head", "stages": pytree with every
    leaf shaped (pp, L/pp, ...)} — leading axis sharded P(pp) under
    make_pp_forward.  Works for any pytree with identical per-layer
    structure; exercised on fp and simulated-quant trees (tests/
    test_cp_pp.py).  Packed (PackedLinear) trees additionally require
    identical static PackedMeta across layers — untested, treat as
    experimental.
    """
    n_layers = cfg.num_hidden_layers
    if n_layers % pp:
        raise ValueError(f"num_hidden_layers {n_layers} % pp {pp} != 0")
    per = n_layers // pp
    layer_list = [params["layers"][str(i)] for i in range(n_layers)]
    stages = jax.tree.map(
        lambda *xs: jnp.stack(xs).reshape(pp, per, *xs[0].shape),
        *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stages
    return out


def stack_pp_stages_v2(params: dict, cfg, pp: int) -> dict:
    """stack_pp_stages + VOCAB-SHARDED edges (PP v2, VERDICT r3 #7).

    v1 replicates embeddings/final-norm/lm_head on every stage for SPMD
    uniformity — ~2 x V x H bytes of dead weight per non-edge device.  v2
    shards BOTH vocab matrices over the pp axis (Megatron-style
    vocab-parallel embedding): each device stores V/pp embedding rows and
    V/pp lm_head rows, shaped (pp, V/pp, H) and sharded P(pp).  The lookup
    becomes a masked local take + one psum of the (B, S, H) activations;
    the lm_head becomes a broadcast of stage pp-1's hidden states (psum of
    (B, S, H)) + a local V/pp-slice matmul whose outputs assemble the
    logits via the out_specs sharding — no (V, H) replication anywhere.
    The tiny final-norm row stays replicated.  fp/simulated-quant lm_head
    (dict) only; PackedLinear lm_heads keep v1."""
    out = stack_pp_stages(params, cfg, pp)
    lm0 = out.get("lm_head")
    if (lm0 is not None and not isinstance(lm0, dict)
            and not cfg.tie_word_embeddings):
        # a PackedLinear lm_head cannot be vocab-sharded here (its packed
        # leaves would be tree-mapped onto P(pp) and the v2 unembed branch
        # would subscript the dataclass) — fail loudly instead of
        # half-converting
        raise ValueError(
            "stack_pp_stages_v2 supports dict (fp/simulated-quant) lm_heads "
            "only; use stack_pp_stages (v1) for PackedLinear lm_heads")
    v, h = out["embed_tokens"]["weight"].shape
    if v % pp:
        raise ValueError(f"vocab_size {v} % pp {pp} != 0")
    out["embed_tokens"] = {
        "weight": out["embed_tokens"]["weight"].reshape(pp, v // pp, h)}
    lm = out.get("lm_head")
    if lm is not None and isinstance(lm, dict):
        out["lm_head"] = {
            "weight": lm["weight"].reshape(pp, v // pp, h),
            "bias": (None if lm.get("bias") is None
                     else lm["bias"].reshape(pp, v // pp)),
        }
    return out


def make_pp_forward(mod, cfg, mesh: Mesh, *, microbatches: int = 0,
                    compute: str = "auto", interpret: bool = False,
                    quant=None):
    """GPipe prefill forward for llama-family models.

    Returns build(staged_params) -> fwd(staged_params, ids) -> logits
    (B, S, V) float32.  staged_params from stack_pp_stages().  The batch
    splits into `microbatches` (default = pp) equal microbatches.
    """
    from smoothquant_tpu.models.common import (ForwardContext,
                                               rotary_cos_sin, unembed)

    pp = mesh.shape[PP_AXIS]
    n_mb = microbatches or pp

    def build(staged):
        # v2 (stack_pp_stages_v2): vocab-sharded edges ride P(pp) like the
        # stage weights; v1 keeps them replicated
        v2 = staged["embed_tokens"]["weight"].ndim == 3
        specs = {
            k: (jax.tree.map(lambda a: P(PP_AXIS), v)
                if k == "stages" or (v2 and k in ("embed_tokens", "lm_head"))
                else jax.tree.map(lambda a: P(), v))
            for k, v in staged.items()
        }
        ctx = ForwardContext(quant=quant, compute=compute,
                             interpret=interpret)
        perm = [(i, (i + 1) % pp) for i in range(pp)]
        out_spec = P(None, None, PP_AXIS) if v2 else P(None, None, None)

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(specs, P(None, None)),
            out_specs=out_spec,
            check_vma=False,
        )
        def fwd(local, ids):
            s_idx = jax.lax.axis_index(PP_AXIS)
            b, s = ids.shape
            if b % n_mb:
                raise ValueError(f"batch {b} % microbatches {n_mb} != 0")
            bm = b // n_mb
            h = local["embed_tokens"]["weight"].shape[-1]

            if v2:
                # vocab-parallel lookup: masked local take + one psum of
                # the (B, S, H) activations (Megatron-style)
                tab = local["embed_tokens"]["weight"][0]     # (V/pp, H)
                vloc = tab.shape[0]
                loc = ids - s_idx * vloc
                ok = jnp.logical_and(loc >= 0, loc < vloc)
                emb = jnp.take(tab, jnp.clip(loc, 0, vloc - 1), axis=0)
                emb = jax.lax.psum(
                    jnp.where(ok[..., None], emb, 0).astype(jnp.float32),
                    PP_AXIS).astype(tab.dtype)
            else:
                emb = jnp.take(local["embed_tokens"]["weight"], ids, axis=0)
            emb_mb = emb.reshape(n_mb, bm, s, h)
            positions = jax.lax.broadcasted_iota(jnp.int32, (bm, s), 1)
            cos, sin = rotary_cos_sin(positions, cfg.head_dim,
                                      cfg.rope_theta)
            stage_layers = jax.tree.map(lambda a: a[0], local["stages"])

            def run_stage(x):
                def body(carry, lp):
                    y, _ = mod._decoder_layer(
                        lp, carry, cfg, "model.layers.pp", cos, sin, ctx,
                        None, None)
                    return y, None

                return jax.lax.scan(body, x, stage_layers)[0]

            def tick(t, carry):
                x_prev, outbuf = carry
                # activation computed last tick arrives from stage s-1
                x_in = jax.lax.ppermute(x_prev, PP_AXIS, perm)
                mb_in = jnp.clip(t, 0, n_mb - 1)
                x0 = jax.lax.dynamic_index_in_dim(
                    emb_mb, mb_in, axis=0, keepdims=False)
                x = jnp.where(s_idx == 0, x0, x_in)
                y = run_stage(x)
                my_mb = t - s_idx                 # microbatch I just did
                write = jnp.logical_and(
                    s_idx == pp - 1,
                    jnp.logical_and(my_mb >= 0, my_mb < n_mb))
                slot = jnp.clip(my_mb, 0, n_mb - 1)
                cur = jax.lax.dynamic_index_in_dim(
                    outbuf, slot, axis=0, keepdims=False)
                outbuf = jax.lax.dynamic_update_index_in_dim(
                    outbuf, jnp.where(write, y, cur), slot, axis=0)
                return y, outbuf

            out0 = jnp.zeros((n_mb, bm, s, h), emb.dtype)
            _, outbuf = jax.lax.fori_loop(
                0, n_mb + pp - 1, tick, (emb_mb[0], out0))

            hs = outbuf.reshape(b, s, h)
            from smoothquant_tpu.models.common import rms_norm

            lm = local.get("lm_head")
            if v2:
                # broadcast stage pp-1's hidden states (B*S*H over the interconnect —
                # tiny next to a (V, H) weight replication), then every
                # stage emits ITS V/pp logit slice; out_specs assembles
                hs = jax.lax.psum(
                    jnp.where(s_idx == pp - 1, hs, 0.0)
                    .astype(jnp.float32), PP_AXIS).astype(hs.dtype)
                hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
                if cfg.tie_word_embeddings or lm is None:
                    w_loc = local["embed_tokens"]["weight"][0]
                else:
                    w_loc = lm["weight"][0]
                logits = unembed(hs, w_loc).astype(jnp.float32)
                if (lm is not None and isinstance(lm, dict)
                        and lm.get("bias") is not None):
                    logits = logits + lm["bias"][0].astype(jnp.float32)
                return logits
            hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
            if cfg.tie_word_embeddings or lm is None:
                logits = unembed(hs, local["embed_tokens"]["weight"])
            elif isinstance(lm, dict):
                logits = unembed(hs, lm["weight"])
            else:  # PackedLinear lm_head
                from smoothquant_tpu.kernels.real_linear import (
                    real_quant_linear,
                )

                logits = real_quant_linear(lm, hs, interpret=interpret,
                                           out_dtype=jnp.float32)
            # only stage pp-1 holds real activations; replicate its answer
            logits = jnp.where(s_idx == pp - 1, logits, 0.0)
            return jax.lax.psum(logits.astype(jnp.float32), PP_AXIS)

        return fwd

    return build


def make_pp_decode(mod, cfg, mesh: Mesh, *, compute: str = "auto",
                   interpret: bool = False, quant=None,
                   quant_kv: bool = False):
    """Cached single-token decode under pipeline parallelism (v1 edges).

    Returns build(staged_params) -> (init_caches, step) where
      init_caches(batch, max_len) -> per-stage stacked cache pytree, every
        field shaped (pp, L/pp, B, ...) and sharded P(pp) — each device
        holds ONLY its own layers' cache (the decode state shards with the
        stage weights, replacing the reference's device_map memory spill,
        SURVEY.md §2.9);
      step(staged, caches, tok) -> (logits (B, V) f32, caches) — one greedy
        decode step: the activation hops stage-to-stage via ppermute over
        pp ticks; stage s's layers run (and its caches update) only on its
        tick, other ticks are masked out.

    Prime the cache by feeding prompt tokens one at a time (teacher
    forcing); microbatch = 1 means no intra-step overlap — PP decode
    trades latency for memory capacity, its reason to exist.
    """
    from smoothquant_tpu.models.common import (ForwardContext, KVCache,
                                               QuantKVCache, rms_norm,
                                               rotary_cos_sin, unembed)

    pp = mesh.shape[PP_AXIS]
    per = cfg.num_hidden_layers // pp
    n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    cache_cls = QuantKVCache if quant_kv else KVCache

    def init_caches(batch: int, max_len: int, dtype=None):
        dtype = jnp.dtype(dtype or cfg.dtype)
        one = cache_cls.create(batch, max_len, n_kv, cfg.head_dim, dtype)
        return jax.tree.map(
            lambda a: jnp.broadcast_to(
                a[None, None], (pp, per) + a.shape).astype(a.dtype)
            if a.ndim else jnp.zeros((pp, per), a.dtype), one)

    def build(staged):
        if staged["embed_tokens"]["weight"].ndim == 3:
            raise ValueError("make_pp_decode supports v1 (replicated-edge) "
                             "staging only; use stack_pp_stages")
        p_specs = {
            k: (jax.tree.map(lambda a: P(PP_AXIS), v) if k == "stages"
                else jax.tree.map(lambda a: P(), v))
            for k, v in staged.items()
        }
        ctx = ForwardContext(quant=quant, compute=compute,
                             interpret=interpret)
        perm = [(i, (i + 1) % pp) for i in range(pp)]

        def cache_specs(caches):
            return jax.tree.map(lambda a: P(PP_AXIS), caches)

        _built = {}

        def step(staged_params, caches, tok):
            """tok: (B,) int32 — the incoming token for every sequence."""
            if "fn" not in _built:
                _built["fn"] = _make_step(cache_specs(caches))
            return _built["fn"](staged_params, caches, tok)

        def _make_step(c_specs):
            @jax.jit
            @functools.partial(
                shard_map, mesh=mesh,
                in_specs=(p_specs, c_specs, P(None)),
                out_specs=(P(None, None), c_specs),
                check_vma=False,
            )
            def _step(local, local_caches, tok):
                s_idx = jax.lax.axis_index(PP_AXIS)
                b = tok.shape[0]
                # drop the leading per-device pp axis (size 1 under shard_map)
                stage_layers = jax.tree.map(lambda a: a[0], local["stages"])
                my_caches = jax.tree.map(lambda a: a[0], local_caches)
                pos = my_caches.pos[0]       # all layers aligned
                x0 = jnp.take(local["embed_tokens"]["weight"], tok[:, None],
                              axis=0)
                positions = jnp.full((b, 1), pos, jnp.int32)
                cos, sin = rotary_cos_sin(positions, cfg.head_dim,
                                          cfg.rope_theta)

                def run_stage(x, stage_caches):
                    def body(carry, layer_in):
                        lp, cache = layer_in
                        y, cache = mod._decoder_layer(
                            lp, carry, cfg, "model.layers.pp", cos, sin,
                            ctx, cache, None)
                        return y, cache

                    return jax.lax.scan(body, x, (stage_layers,
                                                  stage_caches))

                def tick(h, carry):
                    x_prev, caches_c = carry
                    x_in = jax.lax.ppermute(x_prev, PP_AXIS, perm)
                    x = jnp.where(jnp.logical_and(s_idx == 0, h == 0),
                                  x0, x_in)
                    active = s_idx == h
                    y, new_caches = run_stage(x, caches_c)
                    caches_c = jax.tree.map(
                        lambda n, o: jnp.where(active, n, o),
                        new_caches, caches_c)
                    return jnp.where(active, y, x_in), caches_c

                x_fin, my_caches = jax.lax.fori_loop(
                    0, pp, tick, (x0, my_caches))

                # broadcast stage pp-1's hidden state; v1 replicated edges
                hs = jax.lax.psum(
                    jnp.where(s_idx == pp - 1, x_fin, 0.0)
                    .astype(jnp.float32), PP_AXIS).astype(x_fin.dtype)
                hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
                lm = local.get("lm_head")
                if cfg.tie_word_embeddings or lm is None:
                    logits = unembed(hs, local["embed_tokens"]["weight"])
                elif isinstance(lm, dict):
                    logits = unembed(hs, lm["weight"])
                else:  # PackedLinear lm_head
                    from smoothquant_tpu.kernels.real_linear import (
                        real_quant_linear,
                    )

                    logits = real_quant_linear(lm, hs, interpret=interpret,
                                               out_dtype=jnp.float32)
                out_caches = jax.tree.map(lambda a: a[None], my_caches)
                return logits[:, 0].astype(jnp.float32), out_caches

            return _step

        return init_caches, step

    return build
