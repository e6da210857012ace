"""smoothquant_tpu — SmoothQuant + W4A4 mixed-precision inference in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
adithyab100/smoothquant-mixedprecision (see SURVEY.md): SmoothQuant
smoothing as a load-time pytree transform, simulated and real W4A4/W8A8
quantization with per-channel/tensor/token/group (sorted) granularity and
salient-channel mixed precision, Triton Pallas kernels for the GPU hot
path, and pjit/shard_map tensor parallelism over device meshes.
"""

__version__ = "0.1.0"

from smoothquant_tpu.quant import QuantConfig, smooth_model
