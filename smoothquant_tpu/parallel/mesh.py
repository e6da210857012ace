"""Device mesh construction.

The reference has no real parallelism (SURVEY.md §2.9 — only accelerate
device_map layer placement).  Here parallel execution is first-class:
a 2-D (dp, tp) jax.sharding.Mesh where tp spans the NVLink-joined GPUs of
a host and dp spans replicas.  All model-weight sharding specs live in
sharding.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_mesh(
    tp: Optional[int] = None,
    dp: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, tp) mesh.

    Defaults: tp = all devices, dp = 1.  Devices are laid out in
    jax.devices() order: the GPUs of a host are joined all to all by
    NVLink, so the mesh follows the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tp is None:
        tp = n // (dp or 1)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    return Mesh(np.array(devices).reshape(dp, tp), (DP_AXIS, TP_AXIS))
