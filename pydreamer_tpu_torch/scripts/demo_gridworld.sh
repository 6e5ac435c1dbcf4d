#!/bin/bash
# GridWorld end-to-end learning demo of the PyTorch port, run as resumable
# segments: the learner on the card, one CPU generator.
#
#   pydreamer_tpu_torch/scripts/demo_gridworld.sh [RUN_DIR] [TARGET_STEPS] [SEGMENT] [LAUNCHER ARGS...]
#
# Each segment runs the port's launcher to the next multiple of SEGMENT
# gradient steps and exits; the next one resumes from the run's checkpoint
# (the step is read from RUN_DIR/checkpoints/latest.ckpt), which exercises the
# resume path on the way. A failed segment stops the demo; running the script
# again resumes it. Arguments after the third go to the launcher after its
# own, so they override them: e.g. `--gru_type gru_layernorm_dv2` runs kernel
# K1 in both of the learner's loops, `--configs defaults gridworld debug` runs
# the learner on the CPU at a tiny size. Works from any directory.
set -eu
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
RUN_DIR="${1:-runs/grid_demo}"
TARGET_STEPS="${2:-20000}"
SEGMENT="${3:-2500}"
shift $(( $# < 3 ? $# : 3 ))

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
  timeout -k 30 "${SEGMENT_TIMEOUT:-3600}" python -m pydreamer_tpu_torch.launch \
    --config_dir "$ROOT/config" \
    --configs defaults gridworld \
    --run_dir "$RUN_DIR" \
    --n_steps "$cur" \
    --save_interval 100 --log_interval 50 --eval_interval 0 \
    --data_workers 2 --limit_step_ratio 200 "$@"
done
echo "=== demo done at $cur steps ==="
