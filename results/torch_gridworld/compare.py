"""The port's GridWorld run beside the JAX run of ``results/gridworld/``, on
the env-step axis.

    python results/torch_gridworld/compare.py [--port CSV] [--jax CSV] [--out PNG]

Both CSVs are ``export_metrics`` output of a live launcher run. Each segment of
a segmented run starts a new generator, whose ``agent/env_steps`` counts from 0
again, so the axis adds the earlier segments' last counts (a drop in the
column starts a segment). Prints ``agent/return_cum`` (the mean return of the
generator's last 100 episodes) of both runs at the same env steps, and draws
both curves.
"""

import argparse
import csv
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def env_step_curve(path):
    """-> (cumulative env steps, agent/return_cum) of a CSV's agent rows."""
    xs, ys, offset, last = [], [], 0.0, 0.0
    with open(path) as f:
        for row in csv.DictReader(f):
            if not row.get("agent/env_steps") or not row.get("agent/return_cum"):
                continue
            x = float(row["agent/env_steps"])
            if x < last:  # a new segment's generator
                offset += last
            last = x
            xs.append(offset + x)
            ys.append(float(row["agent/return_cum"]))
    return np.asarray(xs), np.asarray(ys)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--port", default=str(HERE / "metrics.csv"))
    p.add_argument("--jax", default=str(HERE.parent / "gridworld" / "metrics.csv"))
    p.add_argument("--out", default=str(HERE / "vs_jax.png"))
    p.add_argument("--points", type=int, default=8)
    args = p.parse_args()

    curves = {"port (PyTorch, H100)": env_step_curve(args.port),
              "JAX (results/gridworld)": env_step_curve(args.jax)}
    (px, py), (jx, jy) = curves.values()
    print(f"port: {len(px)} agent rows to {px[-1]:.0f} env steps; JAX: {len(jx)} rows to "
          f"{jx[-1]:.0f} env steps")
    print("env_steps,port_return_cum,jax_return_cum")
    for x in np.linspace(px[0], px[-1], args.points):
        print(f"{x:.0f},{np.interp(x, px, py):.4f},{np.interp(x, jx, jy):.4f}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, (x, y) in curves.items():
        ax.plot(x, y, label=label)
    ax.set_xlabel("env steps")
    ax.set_ylabel("agent/return_cum (last 100 episodes)")
    ax.set_title("Grid-8x64, `--configs defaults gridworld`")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
