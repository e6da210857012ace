"""Device peaks for roofline shares, keyed by `jax.Device.device_kind`.

A roofline share is the least time the device could take — the larger of
operations over peak rate and bytes over peak bandwidth — divided by the
measured time.  A device that is not in the table is an error, never a
default: dividing by another device's peaks gives a number that means
nothing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_flops: float      # FLOP/s, dense
    int8_ops: float        # OP/s, dense
    hbm_bw: float          # bytes/s
    source: str


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit (a card set lower holds lower clocks under load)
_H100 = ChipSpec("H100", bf16_flops=989e12, int8_ops=1979e12, hbm_bw=3.35e12,
                 source="NVIDIA H100 SXM data sheet")

CHIPS = {
    "NVIDIA H100 80GB HBM3": _H100,
    "NVIDIA H100": _H100,
}


def chip_spec(device_kind: str) -> ChipSpec:
    try:
        return CHIPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak table for device kind {device_kind!r} "
            f"(known: {sorted(CHIPS)})") from None


def detect_chip() -> ChipSpec:
    import jax

    return chip_spec(jax.devices()[0].device_kind)


def bound_seconds(chip: ChipSpec, *, nbytes: float = 0.0,
                  bf16_flops: float = 0.0, int8_ops: float = 0.0):
    """(least time, which bound sets it: "bytes" | "bf16" | "int8")."""
    bounds = {"bytes": nbytes / chip.hbm_bw,
              "bf16": bf16_flops / chip.bf16_flops,
              "int8": int8_ops / chip.int8_ops}
    kind = max(bounds, key=bounds.get)
    return bounds[kind], kind
