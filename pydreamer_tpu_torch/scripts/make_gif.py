"""Turn a ``d2_wm_dream`` / ``d2_wm_closed`` npz dump of the trainer into an
animated GIF: each frame the true image beside the predicted one.

    python -m pydreamer_tpu_torch.scripts.make_gif NPZ OUT_GIF [--batch_index 0] [--fps 8]

The port's counterpart of the JAX side's ``scripts/make_gif.py``, with the
same arguments, over the port's ``analysis.make_dream_gif``.
"""

import argparse

from ..analysis import make_dream_gif


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("npz_path")
    p.add_argument("out_gif")
    p.add_argument("--batch_index", type=int, default=0)
    p.add_argument("--fps", type=int, default=8)
    args = p.parse_args(argv)
    n = make_dream_gif(args.npz_path, args.out_gif, args.batch_index, args.fps)
    print(f"Wrote {n} frames to {args.out_gif}")


if __name__ == "__main__":
    main()
