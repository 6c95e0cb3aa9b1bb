"""The chip's published peaks and the least time a piece of work can take.

Copied from `chip_smoke.py` (`PEAK_BF16`, `PEAK_BYTES`, `bound`), with the
int8 tensor-core rate added. NVIDIA H100 SXM data sheet, dense rates without
sparsity, at the full 700 W power limit: 989 TFLOP/s bf16, 1,979 TOP/s
int8, 3.35 TB/s of HBM3. A card set below 700 W runs slower under load, so
every run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

PEAK_OPS = {
    "bf16": 989e12,    # FLOP/s, dense bf16 tensor cores
    "int8": 1979e12,   # OP/s, dense int8 tensor cores
}
PEAK_BYTES = 3.35e12   # B/s, HBM3


def bound(nbytes: float, ops: dict[str, float]) -> dict:
    """The least time the card could take: the larger of the bytes that must
    move (each input read once, each output written once) over the memory
    rate and the operations of each type over that type's peak, summed."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": dict(ops)}
