"""Plot learning curves of runs, optionally beside a baseline CSV.

    python -m pydreamer_tpu_torch.scripts.plot_curves RUN_DIR [RUN_DIR ...] \
        [--metric agent/return] [--out curves.png] [--baseline_csv CSV] [--smooth N]

The port's counterpart of the JAX side's ``scripts/plot_curves.py``, with the
same arguments, over the port's ``analysis.plot_curves``.
"""

import argparse

from ..analysis import plot_curves


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("run_dirs", nargs="+")
    p.add_argument("--metric", default="agent/return")
    p.add_argument("--out", default="curves.png")
    p.add_argument("--baseline_csv", default=None)
    p.add_argument("--smooth", type=int, default=1)
    args = p.parse_args(argv)
    plot_curves(args.run_dirs, args.metric, args.out, args.baseline_csv, args.smooth)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
