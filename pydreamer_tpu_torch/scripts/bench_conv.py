"""The flagship's conv encoder and decoder, per layer and whole, against their floors.

    python -m pydreamer_tpu_torch.scripts.bench_conv [--layers] [--stacks] [--all]
    python -m pydreamer_tpu_torch.scripts.bench_conv --tiny --device cpu --layers --n 1 --warmup 1

The port's counterpart of ``scripts/bench_conv.py``: the exact convolutions
of the flagship step (64x64x3 -> 2x2x384 and 1x1x1536 -> 64x64x3 over M =
T*B*I = 1536 frames) in bf16, channels-last (the port's modules take
(M,H,W,C) frames and convolve an NCHW view of them), forward and
forward+backward (the gradients of the input and the weights of a sum of
squares). ``--layers``: each conv and transposed conv alone (the port's
``ConvS2`` / ``ConvTransposeS2``, f32 weights cast per call as in the
step); ``--stacks``: the whole ``ConvEncoder`` and ``ConvDecoder``. Each
beside its floor from ``roofline.py``: ``ideal_fwdbwd_ms`` (FLOPs over the
bf16 peak), ``hbm_fwdbwd_ms`` (bytes over the memory rate) and their
maximum, ``floor_fwdbwd_ms``, and the share of the peak reached.

On the card a time is CUDA events around ``--n`` calls after ``--warmup``;
on the CPU it is the host clock, and the floors and peak shares are None.

The JAX script's ``--variants`` compares XLA lowerings of the same convs
(a transposed conv as XLA's own against sub-pixel regrouping, a
space-to-depth stem); the port runs every lowering as the one cuDNN
convolution, so there is nothing to compare and the option is left out
(as is ``bench_step_impl.py``, for the same reason).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.decoders import ConvDecoder, ConvTransposeS2
from ..models.encoders import ConvEncoder, ConvS2
from .flagship import add_device_args, emit, make_conf, sync
from .roofline import conv_layers, conv_row, peaks_for


def time_ms(fn, device, n: int, warmup: int) -> float:
    """ms per call of ``fn``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def fwd_and_fwdbwd(mod, x, device, n, warmup):
    """(forward ms, forward+backward ms) of ``mod`` on ``x``."""
    params = [p for p in mod.parameters()]
    xg = x.detach().requires_grad_()

    def fwd():
        with torch.no_grad():
            return mod(x)

    def fwdbwd():
        loss = mod(xg).float().square().sum()
        return torch.autograd.grad(loss, [xg] + params)

    out = fwd()
    if not torch.isfinite(out.float()).all():
        raise FloatingPointError(f"{type(mod).__name__}: non-finite output")
    return time_ms(fwd, device, n, warmup), time_ms(fwdbwd, device, n, warmup)


def shares(gflop_fwd, ms_fwd, ms_fwdbwd, peak_tflops):
    """TFLOP/s reached and the share of the bf16 peak (None without a peak)."""
    out = {"fwd_tflops": gflop_fwd / ms_fwd, "fwdbwd_tflops": 3 * gflop_fwd / ms_fwdbwd}
    for k in ("fwd", "fwdbwd"):
        out[f"{k}_pct_peak"] = (None if peak_tflops is None
                                else 100 * out[f"{k}_tflops"] / peak_tflops)
    return out


def bench_layers(conf, M, device, n, warmup, peaks):
    rng = np.random.RandomState(0)
    rows = {}
    for layer in conv_layers(conf):
        name, Hi, Wi, Cin, Ho, Wo, Cout, K = layer
        transposed = name.startswith("de")
        mod = (ConvTransposeS2 if transposed else ConvS2)(Cin, Cout, K, dtype=torch.bfloat16)
        mod = mod.to(device)
        x = torch.from_numpy(rng.rand(M, Hi, Wi, Cin).astype(np.float32) - 0.5).to(
            device, torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view of NHWC frames
        fwd, fwdbwd, _, ideal_ms, hbm_ms = conv_row(M, layer, *(
            (peaks[1], peaks[0]) if peaks else (1.0, 1.0)))
        ms_fwd, ms_fwdbwd = fwd_and_fwdbwd(mod, x, device, n, warmup)
        rows[name] = dict(
            shape=f"{Hi}x{Wi}x{Cin} -> {Ho}x{Wo}x{Cout} k{K}" + (" ^T" if transposed else ""),
            fwd_ms=ms_fwd, fwdbwd_ms=ms_fwdbwd, fwd_gflop=fwd / 1e9,
            **shares(fwd / 1e9, ms_fwd, ms_fwdbwd, peaks[1] / 1e12 if peaks else None),
            ideal_fwdbwd_ms=ideal_ms if peaks else None, hbm_fwdbwd_ms=hbm_ms if peaks else None,
            floor_fwdbwd_ms=max(ideal_ms, hbm_ms) if peaks else None)
        print(name, rows[name], flush=True)
    return rows


def bench_stacks(conf, M, device, n, warmup, peaks):
    rng = np.random.RandomState(0)
    d, C = conf.cnn_depth, conf.image_channels
    F = conf.deter_dim + conf.stoch_dim * conf.stoch_discrete
    img = torch.from_numpy(rng.rand(M, 64, 64, C).astype(np.float32) - 0.5).to(
        device, torch.bfloat16)
    feat = torch.from_numpy(rng.rand(M, F).astype(np.float32)).to(device, torch.bfloat16)
    torch.manual_seed(0)
    enc = ConvEncoder(C, d, dtype=torch.bfloat16).to(device)
    dec = ConvDecoder(in_dim=F, out_channels=C, cnn_depth=d, dtype=torch.bfloat16).to(device)
    layers = conv_layers(conf)
    gflop = {"encoder": sum(conv_row(M, layer, 1.0, 1.0)[0] for layer in layers[:4]) / 1e9,
             "decoder": (2 * M * F * 32 * d
                         + sum(conv_row(M, layer, 1.0, 1.0)[0] for layer in layers[4:])) / 1e9}
    rows = {}
    for name, mod, x in (("encoder", enc, img), ("decoder", dec, feat)):
        ms_fwd, ms_fwdbwd = fwd_and_fwdbwd(mod, x, device, n, warmup)
        peak = peaks[1] if peaks else None
        rows[name] = dict(fwd_ms=ms_fwd, fwdbwd_ms=ms_fwdbwd, fwd_gflop=gflop[name],
                          **shares(gflop[name], ms_fwd, ms_fwdbwd, peak / 1e12 if peak else None),
                          ideal_fwdbwd_ms=3 * gflop[name] * 1e9 / peak * 1e3 if peak else None)
        print(name, rows[name], flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--layers", action="store_true")
    p.add_argument("--stacks", action="store_true")
    p.add_argument("--all", action="store_true", help="--layers and --stacks")
    p.add_argument("--n", type=int, default=30, help="timed calls")
    p.add_argument("--warmup", type=int, default=5)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    conf = make_conf(args.tiny)
    M = conf.batch_length * conf.batch_size * conf.iwae_samples
    peaks = peaks_for(torch.cuda.get_device_name(device))[1] if device.type == "cuda" else None
    out = {"M": M, "cnn_depth": conf.cnn_depth}
    if args.layers or args.all:
        out["layers"] = bench_layers(conf, M, device, args.n, args.warmup, peaks)
    if args.stacks or args.all:
        out["stacks"] = bench_stacks(conf, M, device, args.n, args.warmup, peaks)
    return emit(out, device)


if __name__ == "__main__":
    main()
