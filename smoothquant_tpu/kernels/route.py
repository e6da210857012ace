"""Which route an operation takes: its Pallas kernel or plain XLA.

The kernels are written for the GPU through Triton.  They run compiled on a
GPU, and in the Pallas interpreter on the CPU only when a caller passes
interpret=True; nothing interprets on its own.  Everywhere else, and when a
caller asks for the plain route (the benchmark's A/B), XLA compiles the
plain `jax.numpy` version of the same operation.
"""

from __future__ import annotations

import jax


def use_kernel(interpret: bool = False, plain: bool = False) -> bool:
    if plain:
        return False
    return interpret or jax.default_backend() == "gpu"
