"""Benchmark: W4A4 decode and serving at Llama-2-7B width on one GPU.

    python bench.py [--trace-dir DIR]

Prints ONE JSON line on standard output:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Configuration: Llama-2-7B as models/llama.py defines it (32 layers, hidden
4096, MLP 11008, 32 heads, vocab 32000), random weights from a seed, the
flagship recipe — W4A4 g64, 5 % salient channels, bf16 group scales — built
by the library path (smooth_lm → pack_model → stack_layers, as
utils/flagship.py builds it), int8 per-channel lm_head, int8 KV cache.

value: single-token decode tokens/s at batch 4 over a 512-slot cache filled
to 448, the whole 32-layer step timed with a host clock around work that
ends in block_until_ready.  vs_baseline: the same step of the bf16 model
(all 32 layers, per-layer weight buffers, bf16 cache) on the same card
divided by the quantized step.

detail also carries: the plain-XLA A/B of the two Triton kernels (the whole
decode step and serving with ForwardContext(plain=True), and each kernel in
a 32-layer scan of its own), serving tokens/s through ContinuousBatcher,
full-model prefill tokens/s (cuDNN against einsum attention), the bytes a
decode step reads and its share of the card's HBM peak, and the device.
Every peak comes from utils/roofline.py's table for this device kind.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import sys
import time

import numpy as np

CHECKOUT = os.path.dirname(os.path.abspath(__file__))
BATCH, CACHE, FILL = 4, 512, 448
LAYERS = 32


def _log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def decode_step_time(forward_step, params, caches, iters=30):
    """Seconds per decode step: the cache is donated and threaded through
    the loop like a serving loop would."""
    import jax
    import jax.numpy as jnp

    from smoothquant_tpu.utils.benchtools import time_stateful

    tok = jnp.ones((BATCH, 1), jnp.int32)
    step = jax.jit(lambda p, c: forward_step(p, tok, c)[1],
                   donate_argnums=(1,))
    t, caches = time_stateful(lambda c: step(params, c), caches, iters=iters)
    return t, caches


def op_scan_time(op, args, iters=20):
    """Seconds per call of a jitted 32-step lax.scan that runs
    `op(i, *args)` on layer i of loop-invariant stacks — one kernel in the
    decode scan's context, without the rest of the layer.  The stacks are
    jit arguments, never constants folded into the program."""
    import jax
    import jax.numpy as jnp

    from smoothquant_tpu.utils.benchtools import time_calls

    def run(*a):
        def body(acc, i):
            return acc + jnp.sum(op(i, *a).astype(jnp.float32)), None

        return jax.lax.scan(body, jnp.float32(0), jnp.arange(LAYERS))[0]

    return time_calls(jax.jit(run), args, iters=iters) / LAYERS


def trace_summary(fn, logdir: str, top: int = 15) -> dict:
    """Run fn() under the profiler; reduce the device planes of the trace
    to busy time, idle share of the window and the top kernels by device
    time (kernel names: XLA fusion names, or a Pallas call's `name`)."""
    import glob

    import jax
    from jax.profiler import ProfileData

    with jax.profiler.trace(logdir):
        fn()
    path = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))[-1]
    ops, spans = {}, []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                ops[e.name] = ops.get(e.name, 0.0) + e.duration_ns
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
    busy, end = 0.0, None
    for a, b in sorted(spans):           # union of kernel intervals
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "top_ops_ms": {k: v / 1e6 for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=os.path.join(CHECKOUT, "traces"),
                    help="where the decode-step profiler traces go")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    from smoothquant_tpu.kernels import decode_attention as da
    from smoothquant_tpu.kernels.int4_group_matmul import (
        int4_group_matmul_stacked,
    )
    from smoothquant_tpu.kernels.pack import promote_model_int8
    from smoothquant_tpu.models import ForwardContext, llama
    from smoothquant_tpu.models.common import KVCache
    from smoothquant_tpu.serve.batching import ContinuousBatcher, Request
    from smoothquant_tpu.utils import flagship, roofline
    from smoothquant_tpu.utils.benchtools import (card_line,
                                                  enable_compile_cache,
                                                  time_calls)

    enable_compile_cache(CHECKOUT)
    chip = roofline.detect_chip()
    card = card_line()
    _log(f"device {dev.device_kind}; card {card}")
    cfg = llama.LlamaConfig.llama2_7b()
    rng = np.random.default_rng(0)
    detail = {}

    # ---------------- bf16 baseline: all 32 layers, bf16 cache ------------
    # per-layer weight buffers, unrolled: each GEMM reads its weight in
    # place (a dynamic index into a stacked bf16 tree would make XLA copy
    # every layer's weights before its GEMM — a baseline slowed by 3x the
    # bytes says nothing about packing)
    _log("bf16 baseline: init 32 layers")
    bf16 = llama.init_params(jax.random.PRNGKey(1), cfg)
    caches = [KVCache.create(BATCH, CACHE, cfg.num_key_value_heads,
                             cfg.head_dim, jnp.bfloat16)._replace(
                                 pos=jnp.int32(FILL))
              for _ in range(cfg.num_hidden_layers)]

    def fwd_bf16(p, t, c):
        return llama.forward(p, t, cfg, ctx=ForwardContext(), caches=c)

    t_bf, caches = decode_step_time(fwd_bf16, bf16, caches)
    bf_bytes = sum(x.nbytes for x in jax.tree.leaves(
        {k: v for k, v in bf16.items() if k != "embed_tokens"}))
    bf_kv = sum(c.k.nbytes + c.v.nbytes for c in caches)
    _log(f"bf16 decode {t_bf * 1e3:.3f} ms/step")
    del bf16, caches
    gc.collect()

    # ---------------- the quantized model --------------------------------
    qcfg, head_qcfg = flagship.recipes()
    _log("quant model: init + smooth + pack 32 layers")
    packed, _, _ = flagship.build_packed(cfg, qcfg, head_qcfg, seed=2)
    prefill = llama.stack_layers(promote_model_int8(packed), cfg)
    stacked = llama.stack_layers(packed, cfg)
    del packed
    gc.collect()
    w_bytes = sum(x.nbytes for x in jax.tree.leaves(
        {k: v for k, v in stacked.items() if k != "embed_tokens"}))

    t_q = {}
    for mode in ("kernels", "plain"):
        ctx = ForwardContext(quant=qcfg, plain=(mode == "plain"))
        caches = llama.stacked_caches(cfg, BATCH, CACHE, jnp.bfloat16,
                                      pos=FILL, quant_kv=True)

        def fwd_q(p, t, c, ctx=ctx):
            return llama.forward(p, t, cfg, ctx=ctx, caches=c)

        t_q[mode], caches = decode_step_time(fwd_q, stacked, caches)
        _log(f"quant decode ({mode}) {t_q[mode] * 1e3:.3f} ms/step")
        step = jax.jit(lambda p, c, ctx=ctx: llama.forward(
            p, jnp.ones((BATCH, 1), jnp.int32), cfg, ctx=ctx,
            caches=c)[1], donate_argnums=(1,))

        def steps(n=5):
            nonlocal caches
            for _ in range(n):
                caches = step(stacked, caches)
            jax.block_until_ready(caches)

        steps()
        tr = trace_summary(steps, os.path.join(args.trace_dir,
                                               f"decode_{mode}"))
        detail[f"decode_trace_{mode}"] = tr
        _log(f"decode trace ({mode}, 5 steps): busy {tr['busy_ms']:.3f} ms "
             f"of {tr['window_ms']:.3f} ms; top ops "
             + json.dumps({k: round(v, 3)
                           for k, v in tr["top_ops_ms"].items()}))
    kv_bytes = sum(x.nbytes for x in (caches.k_q, caches.v_q,
                                      caches.k_scale, caches.v_scale))
    del caches
    gc.collect()

    # ---------------- each kernel in a 32-layer scan of its own -----------
    ops = {}
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        grp = "self_attn" if name in ("qkv_proj", "o_proj") else "mlp"
        pk = stacked["layers"]["stacked"][grp][name]
        m = pk.meta
        g = m.k_ns // m.group_size
        xq = jnp.asarray(rng.integers(-7, 8, (BATCH, m.k_ns)), jnp.int8)
        xs = jnp.asarray(rng.uniform(0.01, 0.2, (BATCH, g)), jnp.float32)
        x_sal = jnp.asarray(rng.normal(size=(BATCH, m.k_s)), jnp.bfloat16)
        row = {}
        for kern in (True, False):
            op = functools.partial(int4_group_matmul_stacked,
                                   group_size=m.group_size, kernel=kern)
            row["kernel_us" if kern else "plain_us"] = op_scan_time(
                op, (xq, xs, pk.w_qt, pk.w_scales_t, x_sal, pk.w_sal_t)) * 1e6
        nbytes = (pk.w_qt[0].nbytes + pk.w_scales_t[0].nbytes
                  + pk.w_sal_t[0].nbytes)
        bound, kind = roofline.bound_seconds(chip, nbytes=nbytes)
        row.update(bytes=nbytes, bound=kind,
                   kernel_roofline_share=bound / (row["kernel_us"] * 1e-6),
                   plain_roofline_share=bound / (row["plain_us"] * 1e-6))
        ops[f"w4a4 {name} {m.in_features}->{m.out_features} N={BATCH}"] = row
    for s in (512, 4096):
        shape = (LAYERS, BATCH, cfg.num_key_value_heads, s, cfg.head_dim)
        k = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        sc = jnp.asarray(rng.uniform(1e-3, 2e-2, shape[:4]), jnp.float32)
        q = jnp.asarray(rng.normal(size=(BATCH, cfg.num_attention_heads,
                                         cfg.head_dim)), jnp.bfloat16)
        bias = jnp.zeros((BATCH, s), jnp.float32)
        row = {}
        for kern in (True, False):
            op = functools.partial(da.decode_attention_stacked, kernel=kern)
            row["kernel_us" if kern else "plain_us"] = op_scan_time(
                op, (q, k, k, bias, sc, sc)) * 1e6
        nbytes = 2 * (k[0].nbytes + sc[0].nbytes)
        bound, kind = roofline.bound_seconds(chip, nbytes=nbytes)
        row.update(bytes=nbytes, bound=kind,
                   kernel_roofline_share=bound / (row["kernel_us"] * 1e-6),
                   plain_roofline_share=bound / (row["plain_us"] * 1e-6))
        ops[f"decode attention int8 B={BATCH} H={cfg.num_attention_heads} "
            f"S={s}"] = row
        del k, sc
    for name, row in ops.items():
        _log(f"{name}: kernel {row['kernel_us']:.1f} us, plain "
             f"{row['plain_us']:.1f} us, kernel roofline "
             f"{row['kernel_roofline_share']:.3f} ({row['bound']})")
    detail["ops_in_scan"] = ops

    # ---------------- serving through ContinuousBatcher -------------------
    def requests(uid0, n=12, new=32):
        # the same prompt lengths every call: the warm-up wave compiles
        # every graph the timed wave runs
        s_rng = np.random.default_rng(42)
        return [Request(uid=uid0 + i, prompt=s_rng.integers(
            0, cfg.vocab_size, size=(int(s_rng.integers(100, 241)),)),
            max_new_tokens=new) for i in range(n)]

    serving = {}
    for mode in ("kernels", "plain"):
        batcher = ContinuousBatcher(llama, stacked, cfg, quant=qcfg,
                                    max_batch=BATCH, max_len=CACHE,
                                    quant_kv=True, prefill_params=prefill)
        batcher.ctx = dataclasses.replace(batcher.ctx,
                                          plain=(mode == "plain"))
        for r in requests(1000):         # warm every graph of the cycle
            batcher.submit(r)
        batcher.run_to_completion(chunk=8)
        reqs = requests(0)
        for r in reqs:
            batcher.submit(r)
        t0 = time.perf_counter()
        batcher.run_to_completion(chunk=8)
        wall = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in reqs)
        serving[mode] = toks / wall
        _log(f"serving ({mode}) {toks} tokens in {wall:.3f} s = "
             f"{serving[mode]:.1f} tokens/s")
        del batcher
        gc.collect()

    # ---------------- full-model prefill ---------------------------------
    pf_len = 1024
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, pf_len)))
    t_pf = {}
    for mode in ("cudnn", "einsum"):
        ctx = ForwardContext(quant=qcfg, plain=(mode == "einsum"))
        f = jax.jit(lambda p, t, ctx=ctx: llama.forward(p, t, cfg,
                                                         ctx=ctx)[0][:, -1])
        t_pf[mode] = time_calls(f, (prefill, ids), iters=5)
        _log(f"prefill ({mode} attention) {t_pf[mode] * 1e3:.1f} ms for "
             f"{pf_len} tokens")

    step_bytes = w_bytes + kv_bytes
    bound, kind = roofline.bound_seconds(chip, nbytes=step_bytes)
    detail.update({
        "t_quant_ms": t_q["kernels"] * 1e3,
        "t_quant_plain_ms": t_q["plain"] * 1e3,
        "t_bf16_ms": t_bf * 1e3,
        "tokens_per_s_plain": BATCH / t_q["plain"],
        "bf16_tokens_per_s": BATCH / t_bf,
        "step_weight_gb": w_bytes / 1e9,
        "step_kv_gb": kv_bytes / 1e9,
        "bf16_step_gb": (bf_bytes + bf_kv) / 1e9,
        "hbm_roofline_share": bound / t_q["kernels"],
        "bf16_hbm_roofline_share": (bf_bytes + bf_kv) / chip.hbm_bw / t_bf,
        "serving_tokens_per_s": serving["kernels"],
        "serving_tokens_per_s_plain": serving["plain"],
        "prefill_tokens_per_s": pf_len / t_pf["cudnn"],
        "prefill_tokens_per_s_einsum_attention": pf_len / t_pf["einsum"],
        "batch": BATCH, "cache_len": CACHE, "cache_fill": FILL,
        "layers": LAYERS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card,
                   "peaks": dataclasses.asdict(chip)},
    })
    print(json.dumps({
        "metric": ("llama2-7B W4A4 g64 5%-salient decode tokens/s "
                   f"(batch {BATCH}, cache {FILL}/{CACHE}, int8 KV)"),
        "value": BATCH / t_q["kernels"],
        "unit": "tokens/s",
        "vs_baseline": t_bf / t_q["kernels"],
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
