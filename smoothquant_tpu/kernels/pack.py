"""Load-time weight packing for the real quantized execution path.

Turns an FP linear weight + quantization recipe + calibration stats into the
static layout consumed by kernels/real_linear.py:

  * a single static channel permutation [non-salient (magnitude-sorted) |
    salient], replacing the reference's two dynamic mechanisms — boolean-mask
    salient compaction (fake_quant.py:291-304) and per-call argsort grouping
    (fake_quant.py:104-154) — with a load-time layout decision (SURVEY.md §7
    "hard parts").  The sort key is the calibrated per-channel activation
    absmax when available (it drives both act-group quality and, via
    smoothing, weight-group quality), else the weight's column absmax (the
    reference's weight-side key, fake_quant.py:162-167).
  * int4-range weight values in an int8 container, stored TRANSPOSED
    (K_ns, O) — the GEMM B-operand layout — with per-group
    f32 scales (K_ns/group_size, O), zero-padded to whole groups,
  * the salient columns as a dense bf16 block (K_s_pad, O), lane-padded.

Weight numerics match quant/core.group_quant_params exactly, so the packed
path Q-DQs bit-identically to the simulation in the permuted domain.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.quant import core
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.saliency import select_salient_indices

LANE = 128


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PackedLinear:
    """Static-layout quantized linear params (a pytree)."""

    w_qt: jax.Array         # (K_ns, O) int8, int4-range values
    w_scales_t: jax.Array   # (K_ns // group_size, O) f32
    w_sal_t: jax.Array      # (K_s_pad, O) compute dtype
    bias: Optional[jax.Array]
    perm: jax.Array         # (C,) int32: x[:, perm] = [non-salient | salient]
    meta: "PackedMeta" = dataclasses.field(metadata=dict(static=True))
    # identity nibble layout only: (C,) 0/1 mask zeroing the scattered
    # salient channels out of the int path's activation quantize
    ns_mask: Optional[jax.Array] = None


@dataclasses.dataclass(frozen=True)
class PackedMeta:
    in_features: int
    out_features: int
    num_salient: int        # true salient count (before lane padding)
    k_ns: int               # padded non-salient width (multiple of group_size)
    k_s: int                # padded salient width (multiple of LANE; 0 if none)
    group_size: int         # effective WEIGHT group size in the packed domain
    nibble: bool = False    # w_qt holds (k_ns/2, O) split-half packed bytes
    # The activation recipe travels WITH the layer so models can mix
    # precisions (e.g. int8 per-token lm_head over an int4 per-group body):
    act_quant: str = "per_token"
    act_bits: int = 8
    act_group_size: int = 128
    # How a tensor-parallel forward combines this layer's per-device outputs:
    # "gather" = column-parallel + all-gather (v1 scheme, every linear),
    # "none"   = column-parallel, output stays head/neuron-sharded (Megatron
    #            q/k/v/gate/up), "psum" = row-parallel partial sums
    #            all-reduced (Megatron o_proj/down_proj/fc2).
    tp_reduce: str = "gather"
    # Channel layout of w_qt: "permuted" = [sorted non-salient | salient]
    # via perm (the group/nibble kernels' contract); "identity" = ORIGINAL
    # channel order with salient rows zeroed (promote_int8's prefill layout
    # — no per-call activation gather; salient channels are masked out of
    # the int path and ride the fp side path via perm's salient tail).
    layout: str = "permuted"
    # pre_permuted: the INPUT activation already arrives in this pack's
    # permuted channel order, so the runtime gather is skipped.  Produced by
    # fold_input_perm(): a consumer fed by an elementwise chain from another
    # linear (down_proj ← silu(gate)*up) folds its input permutation into
    # the producer's OUTPUT rows at pack time — the decode-path activation
    # gather (a dynamic ~11k-channel gather per layer under lax.scan)
    # becomes a free load-time weight relayout.
    pre_permuted: bool = False


def effective_group_size(cfg: QuantConfig, k_ns_raw: int) -> int:
    """Map the recipe's weight granularity onto the packed group axis.

    per_group → cfg.group_size; per_channel → one group spanning all
    non-salient channels (scale per output row); per_tensor is handled by
    per_channel groups with a shared scale upstream.
    """
    if cfg.weight_quant in ("per_group", "per_group_unsorted"):
        return cfg.group_size
    return max(k_ns_raw, 1)


def pack_linear(
    params: dict,
    cfg: QuantConfig,
    importance: Optional[np.ndarray] = None,
    act_absmax: Optional[np.ndarray] = None,
    compute_dtype=jnp.bfloat16,
    nibble: bool = False,
    host_pack: bool = False,
    align_k_groups: int = 1,
    align_o: int = 1,
    identity: bool = False,
) -> PackedLinear:
    """Build the packed layout from FP linear params {"weight", "bias"}.

    align_k_groups / align_o: round the packed K-groups (per nibble half)
    and the output axis up to these multiples with zero padding (zero group
    scales nullify padded contributions).  No route requires it: the int4
    kernel masks ragged K-groups and output columns itself.

    Default path: only the permutation/salient selection runs on host (tiny
    vectors); the heavy permute/pad/quantize work is jitted on device —
    packing a 7B model is bandwidth-, not Python-, bound.

    host_pack=True quantizes and nibble-packs on the HOST via the native
    OpenMP library (csrc/packlib.cpp; numpy fallback) BEFORE any device
    transfer, so only the packed bytes (~4-8 bits/elt + scales) cross
    host→device instead of the fp weight, and nothing compiles on device —
    the cold-start path for checkpoint ingestion (VERDICT r1 weak #5).
    Bit-identical to the device path.

    nibble=True stores weights two-per-byte (split-half layout; requires
    quant_bits <= 4) — 4 bits/element in HBM, decode-optimal; only the
    int-compute kernel can consume it.
    """
    w = params["weight"]
    o, c = w.shape
    if nibble and cfg.quant_bits > 4:
        raise ValueError("nibble packing requires quant_bits <= 4")
    if identity:
        return _pack_linear_identity(
            params, cfg, importance=importance,
            compute_dtype=compute_dtype, nibble=nibble,
            align_k_groups=align_k_groups, align_o=align_o)

    k = cfg.num_salient(c) if importance is not None else 0
    sal_idx = select_salient_indices(np.asarray(importance), k) if k else np.zeros(0, np.int32)
    is_sal = np.zeros(c, dtype=bool)
    is_sal[sal_idx] = True
    ns_idx = np.nonzero(~is_sal)[0]

    # static sort of non-salient channels: calibrated per-channel absmax when
    # available (it drives act- and, via smoothing, weight-group quality),
    # else the weight-derived key at cfg.sort_strategy
    if cfg.weight_quant == "per_group" or cfg.act_quant == "per_group":
        key = (np.asarray(act_absmax, np.float64)[ns_idx]
               if act_absmax is not None
               else np.asarray(core.sort_key(jnp.asarray(w),
                                             cfg.sort_strategy))[ns_idx])
        ns_idx = ns_idx[np.argsort(key, kind="stable")]

    perm = np.concatenate([ns_idx, np.sort(sal_idx)]).astype(np.int32)
    k_ns_raw = c - k

    g = effective_group_size(cfg, k_ns_raw)
    k_ns = _ceil_to(max(k_ns_raw, 1), g)
    if nibble:
        # both halves must hold whole groups: k_ns multiple of 2*group_size
        k_ns = _ceil_to(k_ns, 2 * g * max(align_k_groups, 1))
    k_s = _ceil_to(k, LANE) if k else 0  # no salient block at all when p=0

    if host_pack:
        w_qt, scales_t, w_sal_t = _pack_host(
            w, perm, k_ns_raw=k_ns_raw, k_ns=k_ns, k_s=k_s, g=g,
            weight_quant=cfg.weight_quant, quant_bits=cfg.quant_bits,
            compute_dtype=jnp.dtype(compute_dtype), nibble=nibble,
        )
        w_qt, scales_t, w_sal_t = (jnp.asarray(w_qt), jnp.asarray(scales_t),
                                   jnp.asarray(w_sal_t))
    else:
        w_qt, scales_t, w_sal_t = _pack_device(
            jnp.asarray(w), jnp.asarray(perm),
            k_ns_raw=k_ns_raw, k_ns=k_ns, k_s=k_s, g=g,
            weight_quant=cfg.weight_quant, quant_bits=cfg.quant_bits,
            compute_dtype=jnp.dtype(compute_dtype),
        )
        if nibble:
            w_qt = _nibble_pack_device(w_qt)

    if align_o > 1:
        o_pad = _ceil_to(o, align_o)
        if o_pad != o:
            w_qt = jnp.pad(w_qt, ((0, 0), (0, o_pad - o)))
            scales_t = jnp.pad(scales_t, ((0, 0), (0, o_pad - o)))
            w_sal_t = jnp.pad(w_sal_t, ((0, 0), (0, o_pad - o)))
            # real_quant_linear slices the kernel output back to out_features

    if cfg.scale_dtype == "bfloat16":
        # narrow STORAGE only: every consumer casts back to f32 before use,
        # so the effective dequant scale is exactly bf16(f32 scale)
        scales_t = scales_t.astype(jnp.bfloat16)

    # a no-sort, no-salient, single-group int8 recipe (e.g. the W8A8
    # per-channel lm_head) needs neither the permute gather nor the group
    # kernel — the identity layout runs ONE XLA int8 dot with a fused
    # epilogue (measured 2.9x the group kernel at the lm_head shape)
    layout = "permuted"
    if (not nibble and k == 0 and k_ns == c
            and cfg.weight_quant in ("per_channel", "per_tensor")
            and cfg.act_quant == "per_token"
            and cfg.effective_act_bits == 8
            and np.array_equal(perm, np.arange(c))):
        layout = "identity"

    bias = params.get("bias")
    return PackedLinear(
        w_qt=w_qt,
        w_scales_t=scales_t,
        w_sal_t=w_sal_t,
        bias=None if bias is None else jnp.asarray(bias),
        perm=jnp.asarray(perm),
        meta=PackedMeta(
            in_features=c, out_features=o, num_salient=k,
            k_ns=k_ns, k_s=k_s, group_size=g, nibble=nibble,
            act_quant=cfg.act_quant, act_bits=cfg.effective_act_bits,
            act_group_size=cfg.group_size, layout=layout,
        ),
    )


def _pack_linear_identity(
    params: dict,
    cfg: QuantConfig,
    importance: Optional[np.ndarray] = None,
    compute_dtype=jnp.bfloat16,
    nibble: bool = True,
    align_k_groups: int = 1,
    align_o: int = 1,
) -> PackedLinear:
    """IDENTITY-layout nibble pack: int weights stay in ORIGINAL channel
    order (groups = contiguous unsorted channel ranges) with the salient
    COLUMNS zeroed out of the int values; salient channels ride the fp
    side path via a SMALL (k_s-wide) runtime gather, and a stored 0/1
    ns_mask zeroes the scattered salient channels out of the activation
    group quantize (their outliers would otherwise inflate neighbors'
    scales).

    Why: the permuted layout needs a full-width activation gather at every
    call whose input isn't pre-permuted (o_proj: ~8 us/layer at 7B decode,
    profiled) — this layout removes it at the cost of unsorted grouping,
    which the reference's own ablation shows is benign at small group
    sizes (README.md:52-55: sorting matters at g=256-1024, not g=64).
    """
    if not nibble:
        raise ValueError("identity layout is for nibble packs")
    if cfg.weight_quant not in ("per_group", "per_group_unsorted"):
        raise ValueError("identity layout needs a per-group weight recipe")
    w = params["weight"]
    o, c = w.shape
    k = cfg.num_salient(c) if importance is not None else 0
    sal_idx = (select_salient_indices(np.asarray(importance), k)
               if k else np.zeros(0, np.int32))
    sal_idx = np.sort(sal_idx).astype(np.int32)
    is_sal = np.zeros(c, dtype=bool)
    is_sal[sal_idx] = True
    ns_idx = np.nonzero(~is_sal)[0].astype(np.int32)
    perm = np.concatenate([ns_idx, sal_idx]).astype(np.int32)

    g = effective_group_size(cfg, c)
    k_ns = _ceil_to(c, 2 * g * max(align_k_groups, 1))
    k_s = _ceil_to(k, LANE) if k else 0

    wf = jnp.asarray(w, jnp.float32)
    mask = jnp.asarray(~is_sal, jnp.float32)
    w_main = wf * mask[None, :]
    if k_ns != c:
        w_main = jnp.pad(w_main, ((0, 0), (0, k_ns - c)))
    q3, s3 = core.group_quant_params(w_main, cfg.quant_bits, g)
    w_qt = _nibble_pack_device(q3.reshape(o, k_ns).T)
    scales_t = s3.reshape(o, k_ns // g).T
    w_sal = jnp.zeros((o, k_s), jnp.float32)
    if k:
        w_sal = w_sal.at[:, :k].set(jnp.take(wf, jnp.asarray(sal_idx),
                                             axis=1))

    if align_o > 1:
        o_pad = _ceil_to(o, align_o)
        if o_pad != o:
            w_qt = jnp.pad(w_qt, ((0, 0), (0, o_pad - o)))
            scales_t = jnp.pad(scales_t, ((0, 0), (0, o_pad - o)))
            w_sal = jnp.pad(w_sal, ((0, o_pad - o), (0, 0)))
    if cfg.scale_dtype == "bfloat16":
        scales_t = scales_t.astype(jnp.bfloat16)

    bias = params.get("bias")
    return PackedLinear(
        w_qt=w_qt,
        w_scales_t=scales_t,
        w_sal_t=w_sal.T.astype(compute_dtype),
        bias=None if bias is None else jnp.asarray(bias),
        perm=jnp.asarray(perm),
        ns_mask=mask.astype(jnp.float32),
        meta=PackedMeta(
            in_features=c, out_features=o, num_salient=k,
            k_ns=k_ns, k_s=k_s, group_size=g, nibble=True,
            act_quant=cfg.act_quant, act_bits=cfg.effective_act_bits,
            act_group_size=cfg.group_size, layout="identity",
            pre_permuted=True,
        ),
    )


def fold_input_perm(
    consumer: PackedLinear, producer_lin: dict, n_splits: int = 1
) -> tuple[PackedLinear, dict]:
    """Fold a packed consumer's input permutation into its FP producer.

    When a packed linear's input is produced by another linear through a
    purely ELEMENTWISE chain (down_proj ← silu(gate)*up), permuting the
    producer's output rows by the consumer's channel perm makes the
    consumer's input arrive pre-permuted — the decode path's dynamic
    activation gather (the costliest per-layer XLA glue under lax.scan)
    becomes a load-time weight relayout.  Exact: same bits flow through the
    kernel either way.

    producer_lin: FP {"weight", "bias"} NOT yet packed (its own packing is
    unaffected — packing permutes its K axis, this permutes its O rows).
    n_splits: for fused producers (gate_up) whose O axis is n_splits blocks
    each feeding the elementwise chain positionally, the perm is applied
    within every block.

    Returns (consumer marked pre_permuted, permuted producer_lin).
    """
    perm = np.asarray(consumer.perm)
    w = producer_lin["weight"]
    o = w.shape[0] // n_splits
    if o != perm.shape[0]:
        raise ValueError(
            f"producer rows per split ({o}) != consumer in_features "
            f"({perm.shape[0]})")
    idx = jnp.asarray(
        np.concatenate([perm + j * o for j in range(n_splits)]))
    bias = producer_lin.get("bias")
    new_producer = {
        "weight": jnp.take(w, idx, axis=0),
        "bias": None if bias is None else jnp.take(bias, idx, axis=0),
    }
    new_consumer = dataclasses.replace(
        consumer,
        meta=dataclasses.replace(consumer.meta, pre_permuted=True))
    return new_consumer, new_producer


def permute_output_columns(packed: PackedLinear, idx: np.ndarray) -> PackedLinear:
    """Relay a packed linear's OUTPUT columns: out'[j] = out[idx[j]].

    Used by the shared-residual-basis layout: producers whose outputs feed
    the residual stream (o_proj, down_proj) emit directly in the shared
    permuted basis, so consumers marked pre_permuted need no runtime
    gather.  Pure load-time relayout of the O axis (w_qt/w_scales_t/
    w_sal_t are (K-ish, O); bias is (O,)); padded O columns (align_o) are
    zeros in every field, so gathering only the true out_features columns
    and re-padding preserves the layout contract."""
    o = packed.meta.out_features
    take = jnp.asarray(np.asarray(idx, np.int32))
    if take.shape[0] != o:
        raise ValueError(f"idx length {take.shape[0]} != out_features {o}")

    def gather_o(arr):
        if arr is None:
            return None
        pad = arr.shape[-1] - o
        out = jnp.take(arr[..., :o], take, axis=-1)
        if pad:
            out = jnp.concatenate(
                [out, jnp.zeros(arr.shape[:-1] + (pad,), arr.dtype)], axis=-1)
        return out

    return dataclasses.replace(
        packed,
        w_qt=gather_o(packed.w_qt),
        w_scales_t=gather_o(packed.w_scales_t),
        w_sal_t=gather_o(packed.w_sal_t),
        bias=None if packed.bias is None else jnp.take(packed.bias, take),
    )


def pack_linear_row_sharded(
    params: dict,
    cfg: QuantConfig,
    tp: int,
    importance: Optional[np.ndarray] = None,
    act_absmax: Optional[np.ndarray] = None,
    compute_dtype=jnp.bfloat16,
    nibble: bool = False,
) -> PackedLinear:
    """Pack a ROW-parallel (input-sharded) linear for Megatron-style TP.

    The input axis is split into `tp` contiguous K-shards and each shard is
    packed independently — its own magnitude sort, salient selection, group
    scales and permutation are all LOCAL to the shard, so no quantization
    group or salient gather ever crosses a device boundary.  Fields are
    concatenated along their K-ish leading axis; sharding each with
    P(tp, ...) in shard_map hands every device exactly its own shard.  meta
    carries LOCAL dimensions (what one device sees) and tp_reduce="psum".

    Numerics note (documented divergence from single-chip packing): sorting,
    per-token activation scales and salient top-k are computed per shard
    instead of globally — a strictly finer granularity.  For
    per_group_unsorted recipes with group_size | (C/tp) and salient_prop=0
    the result is bit-identical to single-chip.

    Bias is stored pre-divided by tp so the post-matmul psum reconstitutes
    it exactly once.
    """
    w = params["weight"]
    o, c = w.shape
    if c % tp:
        raise ValueError(f"in_features {c} not divisible by tp={tp}")
    ksz = c // tp
    shards = []
    for s in range(tp):
        sl = slice(s * ksz, (s + 1) * ksz)
        shards.append(pack_linear(
            {"weight": w[:, sl], "bias": None}, cfg,
            importance=None if importance is None else np.asarray(importance)[sl],
            act_absmax=None if act_absmax is None else np.asarray(act_absmax)[sl],
            compute_dtype=compute_dtype, nibble=nibble,
        ))
    m0 = shards[0].meta
    assert all(p.meta == m0 for p in shards), "non-uniform shard layouts"

    bias = params.get("bias")
    return PackedLinear(
        w_qt=jnp.concatenate([p.w_qt for p in shards], axis=0),
        w_scales_t=jnp.concatenate([p.w_scales_t for p in shards], axis=0),
        w_sal_t=(jnp.concatenate([p.w_sal_t for p in shards], axis=0)
                 if m0.k_s else shards[0].w_sal_t),
        bias=None if bias is None else jnp.asarray(bias) / tp,
        perm=jnp.concatenate([p.perm for p in shards]),
        meta=dataclasses.replace(m0, tp_reduce="psum"),
    )


def unpack_nibbles_to_int8(w_qt: jax.Array) -> jax.Array:
    """(K/2, O) split-half packed bytes (biased nibbles) → (K, O) int8."""
    w32 = w_qt.astype(jnp.int32)
    lo = ((w32 & 0xF) - 8).astype(jnp.int8)
    hi = ((jnp.right_shift(w32, 4) & 0xF) - 8).astype(jnp.int8)
    return jnp.concatenate([lo, hi], axis=0)


@functools.partial(jax.jit, static_argnames=("group_size", "c"))
def _promote_device(w_qt, w_scales_t, dest, *, group_size: int, c: int):
    k_ns = w_qt.shape[0]
    g_total = k_ns // group_size
    wf = (w_qt.astype(jnp.float32).reshape(g_total, group_size, -1)
          * w_scales_t.astype(jnp.float32)[:, None, :]).reshape(k_ns, -1)
    absmax = jnp.max(jnp.abs(wf), axis=0, keepdims=True)      # (1, O)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q8 = jnp.round(wf / scale).astype(jnp.int8)
    # scatter packed rows to their INPUT channel (dest); salient and pad
    # rows drop out (zero rows — their channels ride the fp side path)
    q8_in = jnp.zeros((c, q8.shape[1]), jnp.int8)
    q8_in = q8_in.at[dest].set(q8[: dest.shape[0]])
    return q8_in, scale


def promote_int8(packed: PackedLinear) -> PackedLinear:
    """Re-express an int4-group PackedLinear as int8 per-output-column with
    rows in the order its INPUT arrives (original channel order, or packed
    order for a pre_permuted pack) — the prefill-speed recipe.

    A single full-depth int8 contraction with per-token x per-column output
    scaling runs at the tensor cores' int8 rate (2x bf16) with no per-group
    epilogue work, and the identity layout needs NO per-call activation
    gather: salient channels are simply masked out of the int operand
    (their rows are zero) and ride the fp side path via a small column
    gather.

    Numerically this requantizes the already-Q-DQ'd W4 weight at 8-bit
    per-column granularity: added error <= column absmax / 254 — at most
    half an int4 step of the LARGEST group in the column, second-order next
    to the W4 error itself (tested).  Storage doubles (8 vs 4 bits), so
    serving keeps the int4 tree for decode and promotes once for prefill.
    """
    w_qt = packed.w_qt
    if packed.meta.nibble:
        w_qt = unpack_nibbles_to_int8(w_qt)
    m = packed.meta
    c = m.in_features
    k_ns_raw = c - m.num_salient
    perm = packed.perm
    if m.layout == "identity":
        # rows already in input order (salient rows zeroed)
        dest = jnp.arange(c)
    elif m.pre_permuted:
        # the input arrives in packed order: row i IS input channel i, and
        # the salient channels are the input's tail
        dest = jnp.arange(k_ns_raw)
        perm = jnp.arange(c, dtype=jnp.int32)
    else:
        dest = perm[:k_ns_raw]
    q8, scale = _promote_device(w_qt, packed.w_scales_t, dest,
                                group_size=m.group_size, c=c)
    ns_mask = None
    if m.num_salient:
        # pack-time non-salient mask: saves the per-call scatter in the
        # prefill prologue (real_linear._identity_int8_forward)
        ns_mask = jnp.ones((c,), jnp.float32).at[perm[k_ns_raw:]].set(0.0)
    return PackedLinear(
        w_qt=q8,
        w_scales_t=scale,
        w_sal_t=packed.w_sal_t,
        bias=packed.bias,
        perm=perm,
        ns_mask=ns_mask,
        meta=dataclasses.replace(
            m, nibble=False, group_size=m.in_features, k_ns=m.in_features,
            act_quant="per_token", act_bits=8, layout="identity",
        ),
    )


def promote_model_int8(params):
    """promote_int8 over every PackedLinear in a packed params pytree —
    the prefill twin of a nibble-packed decode tree."""
    def walk(node):
        if isinstance(node, PackedLinear):
            return promote_int8(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def _pack_host(w, perm, *, k_ns_raw, k_ns, k_s, g, weight_quant, quant_bits,
               compute_dtype, nibble):
    """Host-side (numpy / native OpenMP) twin of _pack_device (+ nibble).

    Bit-identical: bf16→f32 is exact, np.round and jnp.round are both
    round-half-to-even, and native.group_quant mirrors
    quant/core.group_quant_params (asserted in tests/test_native.py and
    tests/test_host_pack.py).
    """
    import ml_dtypes

    from smoothquant_tpu.utils import native

    w = np.asarray(w).astype(np.float32)
    o = w.shape[0]
    w_perm = native.permute_cols(w, np.asarray(perm, np.int32))
    w_ns = w_perm[:, :k_ns_raw]
    if k_ns != k_ns_raw:
        w_ns = np.pad(w_ns, ((0, 0), (0, k_ns - k_ns_raw)))
    k = w.shape[1] - k_ns_raw
    w_sal = np.zeros((o, k_s), np.float32)
    if k:
        w_sal[:, :k] = w_perm[:, k_ns_raw:]

    if weight_quant == "per_tensor":
        # all-f32 arithmetic so the scale value matches the device path bitwise
        qmax = np.float32(2 ** (quant_bits - 1) - 1)
        scale = np.maximum(np.max(np.abs(w_ns)), np.float32(1e-5)) / qmax
        q = np.round(w_ns / scale).astype(np.int8)
        scales = np.full((o, k_ns // g), scale, np.float32)
    else:
        q, scales = native.group_quant(w_ns, g, quant_bits)

    w_qt = native.transpose(q)                    # (k_ns, O)
    scales_t = native.transpose(scales)           # (G, O)
    if nibble:
        w_qt = native.pack_nibbles_split(w_qt)
    np_dtype = (ml_dtypes.bfloat16 if compute_dtype == jnp.bfloat16
                else np.dtype(compute_dtype))
    w_sal_t = np.ascontiguousarray(w_sal.T).astype(np_dtype)
    return w_qt, scales_t, w_sal_t


@jax.jit
def _nibble_pack_device(w_qt: jax.Array) -> jax.Array:
    """(K, O) int8 int4-range → (K/2, O) split-half packed bytes (device).

    Nibbles are stored BIASED by +8 (v in [-8,7] → v+8 in [0,15]) so the
    matmul kernel unpacks 8 weights per 32-bit word with two mask ops and
    folds the bias out of the int32 accumulator as -8*sum(x) per group.
    """
    k = w_qt.shape[0]
    lo = (w_qt[: k // 2].astype(jnp.int32) + 8).astype(jnp.uint8) & 0x0F
    hi = ((w_qt[k // 2 :].astype(jnp.int32) + 8).astype(jnp.uint8) & 0x0F) << 4
    return (lo | hi).astype(jnp.int8)


@functools.partial(
    jax.jit,
    static_argnames=("k_ns_raw", "k_ns", "k_s", "g", "weight_quant",
                     "quant_bits", "compute_dtype"),
)
def _pack_device(w, perm, *, k_ns_raw, k_ns, k_s, g, weight_quant, quant_bits,
                 compute_dtype):
    o = w.shape[0]
    w_perm = jnp.take(w.astype(jnp.float32), perm, axis=1)
    w_ns = w_perm[:, :k_ns_raw]
    if k_ns != k_ns_raw:
        w_ns = jnp.pad(w_ns, ((0, 0), (0, k_ns - k_ns_raw)))
    k = w.shape[1] - k_ns_raw
    w_sal = jnp.zeros((o, k_s), jnp.float32)
    if k:
        w_sal = w_sal.at[:, :k].set(w_perm[:, k_ns_raw:])

    if weight_quant == "per_tensor":
        scale = core.compute_scale(jnp.max(jnp.abs(w_ns)), quant_bits)
        scales = jnp.broadcast_to(scale, (o, k_ns // g)).astype(jnp.float32)
        q = jnp.round(w_ns / scale).astype(jnp.int8)
    else:
        q3, s3 = core.group_quant_params(w_ns, quant_bits, g)
        q = q3.reshape(o, k_ns)
        scales = s3.reshape(o, k_ns // g)
    return q.T, scales.T, w_sal.T.astype(compute_dtype)


def quantize_activations_packed(
    x_perm: jax.Array, meta: PackedMeta, cfg: Optional[QuantConfig] = None
) -> tuple[jax.Array, jax.Array]:
    """Split a permuted activation into (Q-DQ'd non-salient, salient).

    x_perm: (N, C) already permuted by PackedLinear.perm.  Non-salient
    channels are zero-padded to k_ns and quantized at meta.act_quant
    granularity (the recipe recorded at pack time; `cfg` is accepted for
    backward compatibility and ignored); because the static permutation
    already ordered channels by magnitude, the "sorted" group variant
    reduces to plain contiguous grouping here.
    """
    del cfg
    n = x_perm.shape[0]
    k_ns_raw = meta.in_features - meta.num_salient
    x_ns = x_perm[:, :k_ns_raw]
    if meta.k_ns != k_ns_raw:
        x_ns = jnp.pad(x_ns, ((0, 0), (0, meta.k_ns - k_ns_raw)))

    if meta.act_quant == "per_token":
        x_ns_q = core.quantize_activation_per_token_absmax(x_ns, meta.act_bits)
    elif meta.act_quant == "per_tensor":
        x_ns_q = core.quantize_activation_per_tensor_absmax(x_ns, meta.act_bits)
    else:  # per_group (static-sorted) / per_group_unsorted
        x_ns_q = core.quantize_activation_per_group_absmax(
            x_ns, meta.act_bits, meta.act_group_size
        )

    x_sal = jnp.zeros((n, meta.k_s), x_perm.dtype)
    if meta.num_salient:
        x_sal = x_sal.at[:, : meta.num_salient].set(x_perm[:, k_ns_raw:])
    return x_ns_q, x_sal


def quantize_activations_packed_int(
    x_perm: jax.Array, meta: PackedMeta, cfg: Optional[QuantConfig] = None
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Integer-domain variant for the int-compute kernel.

    Returns (x_q int8 (N, k_ns), x_scales f32 (N, G_w), x_sal) where G_w =
    k_ns // meta.group_size and the activation scale is constant within each
    weight group (required for the output-side scale factorization).  The
    dequantized product x_q * x_scales reproduces quantize_activations_packed
    bit-for-bit for per_token / per_tensor / matching per_group recipes.
    The recipe comes from meta (recorded at pack time); `cfg` is accepted
    for backward compatibility and ignored.
    """
    from smoothquant_tpu.quant.core import compute_scale

    del cfg
    n = x_perm.shape[0]
    k_ns_raw = meta.in_features - meta.num_salient
    g_w = meta.k_ns // meta.group_size
    x_ns = x_perm[:, :k_ns_raw]
    if meta.k_ns != k_ns_raw:
        x_ns = jnp.pad(x_ns, ((0, 0), (0, meta.k_ns - k_ns_raw)))
    xf = x_ns.astype(jnp.float32)

    if meta.act_quant == "per_token":
        absmax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        scales = compute_scale(absmax, meta.act_bits)  # (N, 1)
        x_q = jnp.round(xf / scales).astype(jnp.int8)
        x_scales = jnp.broadcast_to(scales, (n, g_w))
    elif meta.act_quant == "per_tensor":
        scale = compute_scale(jnp.max(jnp.abs(xf)), meta.act_bits)
        x_q = jnp.round(xf / scale).astype(jnp.int8)
        x_scales = jnp.broadcast_to(scale, (n, g_w))
    else:  # per-group: activation groups must align with weight groups
        if meta.act_group_size != meta.group_size:
            raise ValueError(
                f"int-compute path needs act group_size == weight group_size "
                f"({meta.act_group_size} != {meta.group_size})"
            )
        xg = xf.reshape(n, g_w, meta.group_size)
        absmax = jnp.max(jnp.abs(xg), axis=-1, keepdims=True)
        scales = compute_scale(absmax, meta.act_bits)  # (N, G, 1)
        x_q = jnp.round(xg / scales).astype(jnp.int8).reshape(n, meta.k_ns)
        x_scales = scales[..., 0]

    x_sal = jnp.zeros((n, meta.k_s), x_perm.dtype)
    if meta.num_salient:
        x_sal = x_sal.at[:, : meta.num_salient].set(x_perm[:, k_ns_raw:])
    return x_q, x_scales.astype(jnp.float32), x_sal
