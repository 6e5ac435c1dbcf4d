"""Export a run's metrics.jsonl to CSV, one column per metric.

    python -m pydreamer_tpu_torch.scripts.export_metrics RUN_DIR OUT_CSV [--keys K ...]

The port's counterpart of the JAX side's ``scripts/export_metrics.py``, with
the same arguments, over the port's ``analysis.export_csv``.
"""

import argparse

from ..analysis import export_csv


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("out_csv")
    p.add_argument("--keys", nargs="*", default=None)
    args = p.parse_args(argv)
    n = export_csv(args.run_dir, args.out_csv, args.keys)
    print(f"Wrote {n} rows to {args.out_csv}")


if __name__ == "__main__":
    main()
