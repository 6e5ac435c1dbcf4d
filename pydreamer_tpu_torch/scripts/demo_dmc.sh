#!/bin/bash
# DMC cartpole_balance end-to-end learning run of the PyTorch port, as
# resumable segments (as demo_gridworld.sh): the learner on the card, one CPU
# generator over 4 envs. Needs dm_control.
#
#   pydreamer_tpu_torch/scripts/demo_dmc.sh [RUN_DIR] [TARGET_STEPS] [SEGMENT] [LAUNCHER ARGS...]
#
# ENV_ID (default DMC-cartpole_balance, e.g. DMC-cartpole_swingup) and
# ACTION_DIM (default 1, e.g. 6 for DMC-cheetah_run) pick the task;
# SEGMENT_TIMEOUT bounds a segment in seconds (default 5400). Arguments after
# the third go to the launcher after its own, so they override them.
#
# Changes from the `dmc` preset, with why:
#   gamma 0.99      the discount of DreamerV2's dmc_vision; the preset's
#                   0.999 bootstraps the critic about 10x further than the
#                   H=15 imagination window reaches.
#   batch_size 16   DreamerV2's dmc_vision batch size.
set -eu
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
RUN_DIR="${1:-runs/dmc_cartpole}"
TARGET_STEPS="${2:-20000}"
SEGMENT="${3:-2500}"
shift $(( $# < 3 ? $# : 3 ))
ENV_ID="${ENV_ID:-DMC-cartpole_balance}"
ACTION_DIM="${ACTION_DIM:-1}"

cur=$(python - "$RUN_DIR" <<'PYEOF'
import sys
from pydreamer_tpu_torch.tracking import load_checkpoint_model
ck = load_checkpoint_model(sys.argv[1] + "/checkpoints/latest.ckpt")
print(ck[1] if ck else 0)
PYEOF
)
echo "=== resuming from step $cur ==="
while [ "$cur" -lt "$TARGET_STEPS" ]; do
  cur=$((cur + SEGMENT))
  if [ "$cur" -gt "$TARGET_STEPS" ]; then cur="$TARGET_STEPS"; fi
  echo "=== segment to step $cur ==="
  timeout -k 30 "${SEGMENT_TIMEOUT:-5400}" python -m pydreamer_tpu_torch.launch \
    --config_dir "$ROOT/config" \
    --configs defaults dmc \
    --env_id "$ENV_ID" --action_dim "$ACTION_DIM" \
    --run_dir "$RUN_DIR" \
    --n_steps "$cur" \
    --gamma 0.99 --batch_size 16 \
    --generator_prefill_steps 5000 \
    --generator_log_every 2 \
    --save_interval 200 --log_interval 100 --eval_interval 0 \
    --logbatch_interval 3000 \
    --generator_envs_per_worker 4 \
    --data_workers 2 --limit_step_ratio 64 --max_rss_gb 70 "$@"
done
echo "=== dmc demo done at $cur steps ==="
