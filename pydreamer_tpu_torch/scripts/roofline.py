"""Analytic FLOP and byte roofline of the flagship train step's pieces.

    python -m pydreamer_tpu_torch.scripts.roofline                       # the card's peaks
    python -m pydreamer_tpu_torch.scripts.roofline --peak_tflops 197 --hbm_gbps 810

The port's counterpart of ``scripts/roofline.py``: the same hand counts of
GEMM and conv FLOPs and bytes from the config's dimensions, and the same
JSON rows (the dream scan, the posterior scan, the conv encoder and decoder
layers), so a profile (``profile_step``) or a timing (``bench_conv``) can be
set against the card's ceilings. ``--peak_tflops`` (bf16 tensor FLOP/s) and
``--hbm_gbps`` default to the peaks of the card ``--device`` names, from
NVIDIA's data sheets (``PEAKS``); the CPU has none, so a CPU run must give
both. Given both, nothing runs on a device and the output at the same peaks
is the JAX script's, character for character. The card's name and
nvidia-smi line go to stderr, so the JSON stays the JAX script's.

Also home of ``k1_bound_ms``, the least time of one K1 launch, which
``chip_smoke.py`` reports beside each K1 time.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..device import resolve_device
from .flagship import card, make_conf

# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 tensor FLOP/s,
# fp32 non-tensor FLOP/s, TF32 tensor FLOP/s), at the card's full power
# limit. TF32 is half the bf16 rate (the data sheets give 495 for the SXM part).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 417.5e12),
    "H100": (3.35e12, 989e12, 67e12, 495e12),  # SXM5 (nvidia-smi: "NVIDIA H100 80GB HBM3")
}


def peaks_for(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no peak rates known for card {name!r}")


def k1_bound_ms(M: int, In: int, H: int, peaks, bf16: bool) -> tuple[float, str, str]:
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


def gemm(m, k, n):
    return 2 * m * k * n  # FLOPs


def conv_layers(c):
    """The flagship's convolutions: (name, Hi, Wi, Cin, Ho, Wo, Cout, K).
    Encoder: 4x Conv k4 s2 VALID, 64x64xC -> 31x31xd -> 14x14x2d -> 6x6x4d
    -> 2x2x8d. Decoder: Dense(32d) + 4x ConvTranspose k(5,5,6,6) s2 VALID,
    1x1x32d -> 5x5x4d -> 13x13x2d -> 30x30xd -> 64x64xC."""
    d, C = c.cnn_depth, c.image_channels
    return [
        ("conv0", 64, 64, C, 31, 31, d, 4),
        ("conv1", 31, 31, d, 14, 14, 2 * d, 4),
        ("conv2", 14, 14, 2 * d, 6, 6, 4 * d, 4),
        ("conv3", 6, 6, 4 * d, 2, 2, 8 * d, 4),
        ("deconv0", 1, 1, 32 * d, 5, 5, 4 * d, 5),
        ("deconv1", 5, 5, 4 * d, 13, 13, 2 * d, 5),
        ("deconv2", 13, 13, 2 * d, 30, 30, d, 6),
        ("deconv3", 30, 30, d, 64, 64, C, 6),
    ]


def conv_row(M, layer, peak, bw):
    """One layer's counts: conv fwd = 2*M*Ho*Wo*K^2*Cin*Cout, convT fwd =
    2*M*Hi*Wi*K^2*Cin*Cout; fwd+bwd = 3x fwd (the input-grad and weight-grad
    convs each equal the forward). Bytes (bf16): the forward reads its input
    and writes its output, the backward reads the output's gradient and the
    input and writes the input's gradient; weights are small, so ~2x(in+out)."""
    name, Hi, Wi, Cin, Ho, Wo, Cout, K = layer
    transposed = name.startswith("de")
    spatial = (Hi * Wi) if transposed else (Ho * Wo)
    fwd = 2 * M * spatial * K * K * Cin * Cout
    fwdbwd = 3 * fwd
    hbm_bytes = 2 * (2 * M * Hi * Wi * Cin + 2 * M * Ho * Wo * Cout)
    return fwd, fwdbwd, hbm_bytes, fwdbwd / peak * 1e3, hbm_bytes / bw * 1e3


def rows(c, peak_tflops: float, hbm_gbps: float) -> dict:
    """The JAX script's rows for conf ``c`` at the given peaks."""
    T, B, I = c.batch_length, c.batch_size, c.iwae_samples
    M = T * B * I
    H = c.imag_horizon
    D, S, K, Hd = c.deter_dim, c.stoch_dim, c.stoch_discrete, c.hidden_dim
    Z = S * K
    F = D + Z
    A = c.action_dim
    AH = 400  # actor/critic MLP width (reference a2c default)
    out_stoch = Z if K else 2 * S

    # The dream scan: per step over M examples.
    dream_step = (
        gemm(M, F, AH) + 3 * gemm(M, AH, AH) + gemm(M, AH, A)   # actor MLP
        + gemm(M, Z, Hd) + gemm(M, A, Hd)                       # z_mlp + a_mlp
        + gemm(M, Hd, 3 * D) + gemm(M, D, 3 * D)                # GRU gates
        + gemm(M, D, Hd) + gemm(M, Hd, out_stoch)               # prior MLP
    )
    dream_total = dream_step * H
    # weight bytes streamed per step (bf16), the scan's HBM floor
    wbytes = 2 * (F * AH + 3 * AH * AH + AH * A + Z * Hd + A * Hd
                  + Hd * 3 * D + D * 3 * D + D * Hd + Hd * out_stoch)
    state_bytes = 4 * M * (D + Z)  # f32 carries

    # The posterior scan, per step over B*I rows.
    E = 32 * c.cnn_depth  # conv encoder output embedding
    Mr = B * I
    rssm_step = (
        gemm(Mr, Z, Hd) + gemm(Mr, A, Hd)
        + gemm(Mr, Hd, 3 * D) + gemm(Mr, D, 3 * D)
        + gemm(Mr, D, Hd) + gemm(Mr, E, Hd) + gemm(Mr, Hd, out_stoch)  # post
    )
    rssm_total = rssm_step * T

    peak = peak_tflops * 1e12
    bw = hbm_gbps * 1e9

    d = c.cnn_depth
    conv_rows = {}
    conv_totals = dict(fwd_gflop=0.0, fwdbwd_gflop=0.0,
                       ideal_fwdbwd_ms=0.0, hbm_fwdbwd_ms=0.0)
    for layer in conv_layers(c):
        name, Hi, Wi, Cin, Ho, Wo, Cout, Kk = layer
        fwd, fwdbwd, hbm_bytes, ideal_ms, hbm_ms = conv_row(M, layer, peak, bw)
        conv_rows[name] = {
            "shape": f"{Hi}x{Wi}x{Cin} -> {Ho}x{Wo}x{Cout} k{Kk}",
            "fwd_gflop": round(fwd / 1e9, 1),
            "fwdbwd_gflop": round(fwdbwd / 1e9, 1),
            "ideal_fwdbwd_ms": round(ideal_ms, 3),
            "hbm_fwdbwd_ms": round(hbm_ms, 3),
            "bound": "compute" if ideal_ms > hbm_ms else "memory",
            "intensity_flop_per_byte": round(fwdbwd / hbm_bytes, 1),
        }
        conv_totals["fwd_gflop"] += fwd / 1e9
        conv_totals["fwdbwd_gflop"] += fwdbwd / 1e9
        conv_totals["ideal_fwdbwd_ms"] += ideal_ms
        conv_totals["hbm_fwdbwd_ms"] += hbm_ms
    conv_totals = {k: round(v, 2) for k, v in conv_totals.items()}
    # decoder input dense layer (F -> 32d), part of the "conv pair" budget
    dec_dense = 3 * gemm(M, F, 32 * d)
    conv_totals["dec_dense_fwdbwd_gflop"] = round(dec_dense / 1e9, 1)

    return {
        "conv_pair": {"layers": conv_rows, "totals": conv_totals},
        "dream_scan": {
            "gflop": round(dream_total / 1e9, 1),
            "ideal_compute_ms": round(dream_total / peak * 1e3, 3),
            "ideal_weight_stream_ms": round(H * wbytes / bw * 1e3, 3),
            "per_step_weight_MB": round(wbytes / 1e6, 2),
            "state_MB": round(state_bytes / 1e6, 2),
        },
        "rssm_fwd_scan": {
            "gflop": round(rssm_total / 1e9, 1),
            "ideal_compute_ms": round(rssm_total / peak * 1e3, 3),
        },
        "dims": dict(M=M, H=H, T=T, B=B, D=D, Z=Z, hidden=Hd, F=F,
                     actor_hidden=AH, embed=E),
    }


def card_peaks(device) -> tuple:
    """(bf16 TFLOP/s, HBM GB/s, provenance) of the card ``device`` names."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the CPU has no peak rates here: give --peak_tflops and --hbm_gbps")
    prov = card(device)
    _, (bw, bf16_rate, _, _) = peaks_for(torch.cuda.get_device_name(device))
    return bf16_rate / 1e12, bw / 1e9, prov


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--peak_tflops", type=float, default=None,
                   help="bf16 tensor peak (default: the card's, from PEAKS)")
    p.add_argument("--hbm_gbps", type=float, default=None,
                   help="memory rate (default: the card's, from PEAKS)")
    p.add_argument("--device", default="cuda",
                   help="the card whose peaks are the defaults (cuda; raises without a card)")
    p.add_argument("--tiny", action="store_true", help="the tiny config's dimensions")
    args = p.parse_args(argv)
    peak, bw = args.peak_tflops, args.hbm_gbps
    if peak is None or bw is None:
        card_peak, card_bw, prov = card_peaks(args.device)
        peak = card_peak if peak is None else peak
        bw = card_bw if bw is None else bw
        print(f"# peaks of {prov['device']} ({prov['nvidia_smi']}): {peak} TFLOP/s bf16, "
              f"{bw} GB/s", file=sys.stderr)
    out = rows(make_conf(args.tiny), peak, bw)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
