"""Tensor parallelism for the PACKED (real-kernel) execution path.

Two schemes, selected per PackedLinear by meta.tp_reduce:

v1 (pack_model output, tp_reduce="gather"): every quantizable linear is
column-parallel — its int4/int8 weight block, group scales, salient block
and bias are sharded on the OUTPUT axis across the `tp` mesh axis; each
device runs the Pallas kernel on its shard and the outputs are all-gathered
(ForwardContext.tp_axis in call_linear).  Inputs (and therefore channel
permutations, salient metadata and activation quantization) stay
replicated, so groups never straddle shards and numerics are identical to
single-chip.  Cost: one all-gather per linear.

v2 (pack_model_tp, Megatron-style): q/k/v/gate/up are column-parallel with
tp_reduce="none" — outputs stay head/neuron-sharded, attention runs on
LOCAL heads over a TP-SHARDED KV cache — and o_proj/down_proj are
row-parallel (tp_reduce="psum", packed per K-shard by
pack_linear_row_sharded).  Cost: ONE all-reduce per attention block and one
per MLP block instead of an all-gather per linear, and the KV cache HBM
footprint splits tp-ways.

Works for every registered architecture because the sharding is defined at
the PackedLinear level, not per-model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from smoothquant_tpu.kernels.pack import PackedLinear
from smoothquant_tpu.models.common import ForwardContext
from smoothquant_tpu.parallel.mesh import TP_AXIS


def _packed_specs(p: PackedLinear) -> PackedLinear:
    """PartitionSpec pytree matching a PackedLinear.

    tp_reduce "gather"/"none" (column-parallel): O axis sharded, everything
    per-input-channel replicated.  "psum" (row-parallel, built by
    pack_linear_row_sharded): fields are K-concatenated per shard, so the
    leading axis is sharded and the bias (pre-divided by tp) is replicated.
    """
    if p.meta.tp_reduce == "psum":
        return PackedLinear(
            w_qt=P(TP_AXIS, None),
            w_scales_t=P(TP_AXIS, None),
            w_sal_t=P(TP_AXIS, None),
            bias=None if p.bias is None else P(None),
            perm=P(TP_AXIS),
            ns_mask=None if p.ns_mask is None else P(TP_AXIS),
            meta=p.meta,
        )
    return PackedLinear(
        w_qt=P(None, TP_AXIS),
        w_scales_t=P(None, TP_AXIS),
        w_sal_t=P(None, TP_AXIS),
        bias=None if p.bias is None else P(TP_AXIS),
        perm=P(None),
        ns_mask=None if p.ns_mask is None else P(None),
        meta=p.meta,
    )


def packed_model_specs(params):
    """Spec pytree for a packed params tree: PackedLinears O-sharded,
    everything else replicated."""
    def spec_of(node):
        if isinstance(node, PackedLinear):
            return _packed_specs(node)
        if isinstance(node, dict):
            return {k: spec_of(v) for k, v in node.items()}
        if node is None:
            return None
        return P(*([None] * node.ndim))

    return spec_of(params)


def assert_tp_divisible(params, tp: int) -> None:
    def walk(node):
        if isinstance(node, PackedLinear):
            if node.meta.tp_reduce in ("gather", "none"):
                o = node.meta.out_features
                if o % tp:
                    raise ValueError(
                        f"out_features {o} not divisible by tp={tp}")
            # "psum" leaves are K-concatenated per shard by construction;
            # "rep" leaves are replicated
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(params)


def pack_model_tp(
    arch: str,
    params: dict,
    cfg,
    qcfg,
    tp: int,
    input_feat: Optional[dict] = None,
    act_scales: Optional[dict] = None,
    compute_dtype=None,
    nibble: bool = False,
    lm_head_qcfg=None,
) -> dict:
    """Megatron-aware packing: COL layers packed globally (tp_reduce="none",
    O-axis sharded later), ROW layers packed per K-shard
    (pack_linear_row_sharded, tp_reduce="psum"), replicated layers (e.g. the
    Mixtral router gate) packed whole (tp_reduce="rep")."""
    import jax.numpy as jnp
    import numpy as np

    from smoothquant_tpu.kernels.pack import pack_linear, pack_linear_row_sharded
    from smoothquant_tpu.models.registry import get_arch
    from smoothquant_tpu.parallel.sharding import ARCH_LINEAR_STYLES, COL, REP, ROW
    from smoothquant_tpu.quant.smooth import _get_path, _set_path

    mod = get_arch(arch)
    styles = ARCH_LINEAR_STYLES[arch]
    compute_dtype = compute_dtype or jnp.dtype(getattr(cfg, "dtype", "bfloat16"))
    for path, key, _qo in mod.quantizable_linears(cfg):
        style = styles.get(path[-1], COL)
        lin = _get_path(params, path)
        imp = None if input_feat is None else np.asarray(input_feat[key])
        absmax = None if act_scales is None else np.asarray(act_scales[key])
        if style == ROW:
            packed = pack_linear_row_sharded(
                lin, qcfg, tp, importance=imp, act_absmax=absmax,
                compute_dtype=compute_dtype, nibble=nibble)
        else:
            packed = pack_linear(lin, qcfg, importance=imp, act_absmax=absmax,
                                 compute_dtype=compute_dtype, nibble=nibble)
            if style == COL and packed.meta.out_features % tp:
                raise ValueError(
                    f"{'.'.join(path)}: out_features "
                    f"{packed.meta.out_features} not divisible by tp={tp}")
            packed = dataclasses.replace(
                packed, meta=dataclasses.replace(
                    packed.meta, tp_reduce="rep" if style == REP else "none"))
        params = _set_path(params, path, packed)
    if lm_head_qcfg is not None and isinstance(params.get("lm_head"), dict):
        params = dict(params)
        # vocab-dim column-parallel with an all-gather (tp_reduce default)
        params["lm_head"] = pack_linear(params["lm_head"], lm_head_qcfg,
                                        compute_dtype=compute_dtype)
    return params


def make_tp_forward_v2(mod, cfg, mesh, *, compute: str = "auto",
                       interpret: bool = False, overlap_chunks: int = 0):
    """Megatron-style TP forward for a pack_model_tp() pytree.

    Attention runs on LOCAL heads (the KV cache, if used, is tensor-sharded
    over heads); o_proj/down_proj psum.  Exactly two all-reduces per decoder
    layer.  Requires a config with a head_dim_value field (llama-family) and
    tp | num_attention_heads, tp | num_key_value_heads.

    overlap_chunks > 1 pipelines each row-parallel reduce: the token axis
    splits into independent (matmul, psum) chunks so chunk c's all-reduce
    overlaps chunk c+1's matmul under XLA's latency-hiding scheduler
    (bitwise-identical logits; scripts/tp_overlap_trace.py records the
    interleaved schedule).
    """
    tp = mesh.shape[TP_AXIS]
    nh = cfg.num_attention_heads
    nkv = getattr(cfg, "num_key_value_heads", nh)
    if not any(f.name == "head_dim_value"
               for f in dataclasses.fields(cfg)):
        raise NotImplementedError(
            "make_tp_forward_v2 needs a config with head_dim_value "
            "(llama-family); use make_tp_forward for other archs")
    if nh % tp or nkv % tp:
        raise ValueError(f"tp={tp} must divide heads ({nh}) and kv heads ({nkv})")
    cfg_local = dataclasses.replace(
        cfg, num_attention_heads=nh // tp, num_key_value_heads=nkv // tp,
        head_dim_value=cfg.head_dim)

    def build(params):
        specs = packed_model_specs(params)
        ctx = ForwardContext(compute=compute, interpret=interpret,
                             tp_axis=TP_AXIS,
                             tp_overlap_chunks=overlap_chunks)

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(specs, P(None, None)),
            out_specs=P(None, None, None),
            check_vma=False,
        )
        def fwd(local_params, ids):
            logits, _ = mod.forward(local_params, ids, cfg_local, ctx=ctx)
            return logits

        return fwd

    return build


def make_tp_decode_v2(mod, cfg, mesh, *, compute: str = "auto",
                      interpret: bool = False):
    """Megatron-TP decode step WITH a tensor-sharded KV cache.

    Returns build(params) -> step(params, ids, caches) -> (logits, caches),
    where caches is a list of common.KVCache/QuantKVCache over GLOBAL head
    counts; shard_map splits them on the head axis so each device attends
    over its local heads only (the KV cache is sharded over the devices)
    and the packed linears run exactly as in make_tp_forward_v2.  The
    serving layer (Generator / ContinuousBatcher) can drive this step as a
    drop-in for the single-chip forward.
    """
    tp = mesh.shape[TP_AXIS]
    nh = cfg.num_attention_heads
    nkv = getattr(cfg, "num_key_value_heads", nh)
    if not any(f.name == "head_dim_value" for f in dataclasses.fields(cfg)):
        raise NotImplementedError("make_tp_decode_v2 needs head_dim_value")
    if nh % tp or nkv % tp:
        raise ValueError(f"tp={tp} must divide heads ({nh}) and kv ({nkv})")
    cfg_local = dataclasses.replace(
        cfg, num_attention_heads=nh // tp, num_key_value_heads=nkv // tp,
        head_dim_value=cfg.head_dim)

    def cache_specs(caches):
        def leaf_spec(a):
            if a.ndim == 4:     # (B, H, S, D)
                return P(None, TP_AXIS, None, None)
            if a.ndim == 3:     # (B, H, S) quant scales
                return P(None, TP_AXIS, None)
            return P()          # pos
        return jax.tree.map(leaf_spec, caches)

    def build(params, caches_template):
        specs = packed_model_specs(params)
        cspecs = cache_specs(caches_template)
        ctx = ForwardContext(compute=compute, interpret=interpret,
                             tp_axis=TP_AXIS)

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(specs, P(None, None), cspecs),
            out_specs=(P(None, None, None), cspecs),
            check_vma=False,
        )
        def step(local_params, ids, caches):
            logits, caches = mod.forward(local_params, ids, cfg_local,
                                         ctx=ctx, caches=caches)
            return logits, caches

        return step

    return build


def make_tp_forward(mod, cfg, qcfg, mesh, *, compute: str = "auto",
                    interpret: bool = False):
    """Build a jitted tensor-parallel forward for a packed model.

    Returns forward_tp(params, input_ids) -> logits, running under shard_map
    over `mesh`'s tp axis.  params must be the GLOBAL packed pytree (shard_map
    splits it per packed_model_specs).
    """
    tp = mesh.shape[TP_AXIS]

    def build(params):
        assert_tp_divisible(params, tp)
        specs = packed_model_specs(params)
        ctx = ForwardContext(quant=qcfg, compute=compute, interpret=interpret,
                             tp_axis=TP_AXIS)

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(specs, P(None, None)),
            out_specs=P(None, None, None),
            check_vma=False,
        )
        def fwd(local_params, ids):
            logits, _ = mod.forward(local_params, ids, cfg, ctx=ctx)
            return logits

        return fwd

    return build
