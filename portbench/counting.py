"""The yardstick's arithmetic: operations and bytes of the attack's layers
counted from shapes, and the card's published peaks.

Every count is what the inputs need, whatever the program does: padded
rows, repeated reads and recomputation are the program's cost, not work.
"""

from __future__ import annotations

from portbench import nets

# NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity), at the full
# 700 W power limit: operations/s per precision, bytes/s of HBM3
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
        "float16": 989e12, "fp8": 1979e12, "int8": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "fp8": 1}


def peaks(device_kind: str) -> dict | None:
    """The peaks of the card named ``device_kind``, or None for a card the
    table does not know (its rooflines are then not read)."""
    return PEAKS.get(device_kind)


def tower_macs(net: str, res: int) -> int:
    """Multiply-accumulates of one image through the tower's convolutions
    (pooling and ReLU are not counted)."""
    macs = 0
    for layer, _h, _w, c, ho, wo, co in nets.walk(net, res):
        if layer[0] == "conv":
            k = layer[2]
            macs += ho * wo * co * c * k * k
    return macs


def tower_flops(net: str, res: int) -> int:
    return 2 * tower_macs(net, res)


def tap_elements(net: str, res: int) -> int:
    """Elements of all taps of one image."""
    return sum(h * w * c for h, w, c in nets.tap_shapes(net, res))


def embed_dim(net: str, res: int) -> int:
    """K: the pixel part (res * res * 3) plus every tap's elements."""
    return res * res * 3 + tap_elements(net, res)


def k2_bytes(net: str, res: int, images: int, tap_dtype: str,
             part_dtype: str) -> int:
    """Least bytes of the tap epilogue over ``images`` images: every tap
    element read once in the tower's dtype, every part element written
    once in the part's dtype, and one float32 norm per image and tap."""
    n_taps = len(nets.tap_shapes(net, res))
    per_image = (tap_elements(net, res)
                 * (BYTES[tap_dtype] + BYTES[part_dtype]) + 4 * n_taps)
    return images * per_image


def fold_ops(n_q: int, n_s: int, k: int) -> int:
    """Operations of the distance fold: one multiply-add (two operations)
    per query, synthetic image and embedding element."""
    return 2 * n_q * n_s * k


def fold_bytes(n_q: int, n_s: int, k: int, part_dtype: str) -> int:
    """Least bytes of the fold: both embedding sets read once, one float32
    norm per row read, and one distance and one index per query
    written."""
    return (n_q + n_s) * (k * BYTES[part_dtype] + 4) + n_q * 8


def least_seconds(ops: float, precision: str, nbytes: float,
                  device_kind: str) -> float | None:
    """The larger of ``ops`` at the precision's peak and ``nbytes`` at the
    HBM peak; None for a card without peaks."""
    p = peaks(device_kind)
    if p is None:
        return None
    return max(ops / p[precision], nbytes / p["hbm_bytes_per_s"])
