"""The card's peak rates and K1's least time per launch.

``PEAKS`` and ``k1_bound_ms`` are copied from the port's
``pydreamer_tpu_torch/scripts/roofline.py`` (``PEAKS``, ``peaks_for`` and
``k1_bound_ms``; ``chip_smoke.py`` imports the same function). The rates are
NVIDIA's data-sheet dense peaks at the card's full power limit: (bytes/s,
bf16 tensor FLOP/s, fp32 non-tensor FLOP/s, TF32 tensor FLOP/s).
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks_for", "k1_bound_ms"]

PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 417.5e12),
    "H100": (3.35e12, 989e12, 67e12, 495e12),  # SXM5 (nvidia-smi: "NVIDIA H100 80GB HBM3")
}


def peaks_for(name: str):
    """(key, peaks) of the first ``PEAKS`` entry whose key is in the card's name."""
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no peak rates known for card {name!r}")


def k1_bound_ms(M: int, In: int, H: int, peaks, bf16: bool) -> tuple:
    """Least time for one K1 step: each input read once, the output written once;
    the two products at the bf16 tensor rate (bf16 operands) or, for f32
    operands at full f32 accuracy, by the faster of two routes: FFMA at the
    fp32 rate, or 3xTF32 (three TF32 products each) at the TF32 tensor rate;
    LayerNorm and gates at the fp32 rate. -> (ms, "bytes" or "operations",
    the route of the products: "bf16", "ffma" or "3xtf32")."""
    bw, bf16_rate, f32_rate, tf32_rate = peaks
    elem = 2 if bf16 else 4
    nbytes = elem * (M * In + M * H + In * 3 * H + H * 3 * H) + 4 * (2 * 3 * H) + 4 * M * H
    t_bytes = nbytes / bw
    flops = 2 * M * (In + H) * 3 * H
    routes = {"bf16": flops / bf16_rate} if bf16 else {"ffma": flops / f32_rate,
                                                       "3xtf32": 3 * flops / tf32_rate}
    route = min(routes, key=routes.get)
    t_ops = routes[route] + M * (8 * 3 * H + 10 * H) / f32_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), route
