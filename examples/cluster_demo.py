"""Multi-host serving tier demo: request distribution over batcher replicas.

Runs the ClusterFrontend (serve/cluster.py) with two host replicas of a
quantized tiny Llama, mixed-length requests, least-outstanding-work routing,
and prints the per-host / cluster throughput metrics.  In a deployment each
replica runs on its own host (TP over NVLink inside the host); here both
step in one process, which validates scheduling, determinism, and the
metric machinery.

  python examples/cluster_demo.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax

    from smoothquant_tpu.models import llama
    from smoothquant_tpu.models.registry import quantize_model
    from smoothquant_tpu.quant import QuantConfig
    from smoothquant_tpu.serve import ClusterFrontend, ContinuousBatcher, Request

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8)
    qparams = quantize_model("llama", params, cfg, qcfg)

    def make_batcher(host_id: int) -> ContinuousBatcher:
        return ContinuousBatcher(llama, qparams, cfg, quant=qcfg,
                                 max_batch=2, max_len=64)

    cluster = ClusterFrontend(make_batcher, n_hosts=2)
    rng = np.random.default_rng(0)
    for uid, n in enumerate(rng.integers(3, 14, size=8)):
        cluster.submit(Request(
            uid=uid, prompt=rng.integers(0, cfg.vocab_size, size=(int(n),)),
            max_new_tokens=6))

    done = cluster.run_to_completion()
    for req in sorted(done, key=lambda r: r.uid):
        print(f"req {req.uid}: prompt {len(req.prompt):2d} tokens → "
              f"{req.generated}")
    print(json.dumps(cluster.stats(), indent=1, default=float))


if __name__ == "__main__":
    main()
