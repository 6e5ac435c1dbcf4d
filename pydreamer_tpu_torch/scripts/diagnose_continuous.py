"""Continuous-control stability diagnostic: the live actor-learner loop in one
process on the ``Point-2x32`` canary, with DMC-like hyperparameters
(``tanh_normal`` actor, dynamics gradients), so that a suspect can be tested
one at a time:

    python -m pydreamer_tpu_torch.scripts.diagnose_continuous --gamma 0.999 --steps 3000
    python -m pydreamer_tpu_torch.scripts.diagnose_continuous --gamma 0.99 --steps 3000
    python -m pydreamer_tpu_torch.scripts.diagnose_continuous --actor_grad reinforce ...

The port's counterpart of the JAX side's ``scripts/diagnose_continuous.py``,
with its arguments and ``--device``, over the loops of ``canaries.py``. One
episode of the current policy is collected every ``--train_every`` steps and
the replay re-lists its files every 5 s. Prints one CSV row per window: the
step, the mean return of the episodes collected in it, and the window's mean
policy entropy and value, imagined reward, gradient norms and losses; then,
on stderr, the last and the best window's return.
"""

import argparse
import csv
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import canaries
from ..envs import create_env

COLUMNS = ("step", "return", "loss_model", "loss_actor", "loss_critic", "policy_entropy",
           "policy_value", "policy_value_im", "policy_reward", "grad_norm", "grad_norm_actor",
           "grad_norm_critic")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--entropy", type=float, default=1e-4)
    p.add_argument("--target_interval", type=int, default=100)
    p.add_argument("--actor_grad", type=str, default="dynamics")
    p.add_argument("--actor_dist", type=str, default="tanh_normal")
    p.add_argument("--adam_lr_actor", type=float, default=1e-4)
    p.add_argument("--adam_lr_critic", type=float, default=1e-4)
    p.add_argument("--grad_clip_ac", type=float, default=200.0)
    p.add_argument("--imag_horizon", type=int, default=15)
    p.add_argument("--train_every", type=int, default=8,
                   help="grad steps per collected episode (lower = more data)")
    p.add_argument("--window", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    conf = canaries.point_conf(
        imag_horizon=args.imag_horizon, gamma=args.gamma, entropy=args.entropy,
        target_interval=args.target_interval, actor_grad=args.actor_grad,
        actor_dist=args.actor_dist, adam_lr_actor=args.adam_lr_actor,
        adam_lr_critic=args.adam_lr_critic, grad_clip_ac=args.grad_clip_ac)
    data_dir = Path(tempfile.mkdtemp(prefix="diag_cont_")) / "episodes"
    canaries.collect_random(canaries.POINT_ENV, data_dir, 2000, 500, device=args.device)
    learner = canaries.Learner(conf, data_dir, args.device, args.seed, reload_interval=5,
                               buffer_size=200_000)
    env = create_env(canaries.POINT_ENV, no_terminal=False, env_time_limit=0,
                     env_action_repeat=1, worker_id=100 + args.seed)
    policy = learner.policy(100 + args.seed)
    episode = 1000

    out = csv.writer(sys.stdout)
    out.writerow(COLUMNS)
    rows, agg = [], {}
    learner.reset_state()
    for i in range(1, args.steps + 1):
        metrics = learner.step(i)
        if i % args.train_every == 0:
            agg.setdefault("return", []).extend(
                canaries.collect(learner, policy, env, 1, episode))
            episode += 1
        for k in COLUMNS[2:]:
            if k in metrics:
                agg.setdefault(k, []).append(float(metrics[k]))
        if i % args.window == 0:
            row = {k: float(np.mean(v)) for k, v in agg.items()}
            row["step"] = i
            rows.append(row)
            out.writerow([row.get(k, float("nan")) for k in COLUMNS])
            sys.stdout.flush()
            agg = {}

    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows))
    if rows:
        last = rows[-1].get("return", float("nan"))
        peak = max(r.get("return", float("nan")) for r in rows)
        print(f"FINAL return={last:.2f} peak={peak:.2f} (random ~12.5, optimal ~29 for "
              f"{canaries.POINT_ENV})", file=sys.stderr)


if __name__ == "__main__":
    main()
