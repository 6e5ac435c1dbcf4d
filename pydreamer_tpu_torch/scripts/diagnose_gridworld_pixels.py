"""Tune the pixel policy-improvement canary: the GridWorld-pixels training
loop with a live-rollout evaluation every window, so that the canary's step
budget and hyperparameters come from evidence.

    python -m pydreamer_tpu_torch.scripts.diagnose_gridworld_pixels \
        --steps 1000 --eval_every 200 [--online_every 6] [--device cuda]

The port's counterpart of the JAX side's ``scripts/diagnose_gridworld_pixels.py``,
with its arguments and ``--device``, over the loops of ``canaries.py``. Prints
one CSV row per window: the step, the mean return of 30 live rollouts, and
the last step's policy entropy, imagined value, world-model loss and
imagined reward.
"""

import argparse
import csv
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import canaries
from ..envs import create_env

COLUMNS = ("step", "return", "policy_entropy", "policy_value_im", "loss_model", "policy_reward")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--time_limit", type=int, default=12)
    p.add_argument("--entropy", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--imag_horizon", type=int, default=8)
    p.add_argument("--data_steps", type=int, default=1200)
    p.add_argument("--online_every", type=int, default=0,
                   help=">0: collect 1 episode with the current policy every N grad steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    env_id = f"Grid-{args.grid}x64"
    conf = canaries.gridworld_pixels_conf(
        env_id=env_id, env_time_limit=args.time_limit, imag_horizon=args.imag_horizon,
        gamma=args.gamma, entropy=args.entropy)
    data_dir = Path(tempfile.mkdtemp(prefix="diag_px_")) / "episodes"
    canaries.collect_random(env_id, data_dir, args.data_steps, 300,
                            env_time_limit=args.time_limit, device=args.device)
    learner = canaries.Learner(conf, data_dir, args.device, args.seed,
                               reload_interval=5 if args.online_every else 0,
                               buffer_size=500_000)
    online_env = create_env(env_id, False, args.time_limit, 1, 50 + args.seed)
    online_policy = learner.policy(50 + args.seed)
    episode = 10_000

    def live_return(seed):
        return float(np.mean(canaries.rollout_returns(learner, env_id, 30, seed,
                                                      env_time_limit=args.time_limit)))

    out = csv.writer(sys.stdout)
    out.writerow(COLUMNS)
    out.writerow([0, live_return(7)] + [float("nan")] * (len(COLUMNS) - 2))
    sys.stdout.flush()
    learner.reset_state()
    i = 0
    while i < args.steps:
        for _ in range(args.eval_every):
            i += 1
            metrics = learner.step(i)
            if args.online_every and i % args.online_every == 0:
                canaries.collect(learner, online_policy, online_env, 1, episode)
                episode += 1
        m = {k: float(v) for k, v in metrics.items()}
        out.writerow([i, live_return(100 + i)] + [m[k] for k in COLUMNS[2:]])
        sys.stdout.flush()


if __name__ == "__main__":
    main()
