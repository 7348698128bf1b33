#!/usr/bin/env bash
# Staged curriculum for the Sensors-20 baseline scenario
# (reference old_cfg/stage_train.yaml workflow: train easy -> harder ->
# the 10obs+5ped benchmark, warm-starting each stage from the last).
#
#   bash examples/train_curriculum.sh [OUTDIR]
#
# Produces OUTDIR/stage{1,2,3}_ckpt + learning-curve csv/png per stage,
# then a 50-episode deterministic ScenarioBank eval of the final policy.
set -euo pipefail
cd "$(dirname "$0")/.."
OUT="${1:-/tmp/curriculum}"
mkdir -p "$OUT"
S=${SCENES:-32}
PY=python

$PY examples/train_ppo.py img_env_tpu/configs/baseline_stage1.yaml \
    --scenes "$S" --updates "${U1:-600}" --unroll 16 --lr 3e-4 \
    --reward-scale 0.02 --sigma0 -1.0 \
    --curve "$OUT/stage1" --save "$OUT/stage1_ckpt" 2>&1 | tail -20

$PY examples/train_ppo.py img_env_tpu/configs/baseline_stage2.yaml \
    --scenes "$S" --updates "${U2:-800}" --unroll 16 --lr 2e-4 \
    --reward-scale 0.02 --sigma0 -1.2 \
    --restore "$OUT/stage1_ckpt" \
    --curve "$OUT/stage2" --save "$OUT/stage2_ckpt" 2>&1 | tail -20

$PY examples/train_ppo.py img_env_tpu/configs/baseline_10obs_5ped.yaml \
    --scenes "$S" --updates "${U3:-1200}" --unroll 16 --lr 1e-4 \
    --reward-scale 0.02 --sigma0 -1.4 \
    --restore "$OUT/stage2_ckpt" \
    --curve "$OUT/stage3" --save "$OUT/stage3_ckpt" 2>&1 | tail -20

# polish stages: anneal exploration explicitly (a restored checkpoint
# carries its own sigma; the entropy bonus would otherwise hold it up).
# Evaluated outcomes (docs/artifacts/baseline_curriculum): stage 3 0.84
# arrive / 0.10 collisions, stage 4 0.88 / 0.06, stage 5 0.88 / 0.04
# (50-episode bank).
$PY examples/train_ppo.py img_env_tpu/configs/baseline_10obs_5ped.yaml \
    --scenes "$S" --updates "${U4:-3000}" --unroll 16 --lr 5e-5 \
    --reward-scale 0.02 --ent-coef 0.002 --force-sigma -1.6 \
    --restore "$OUT/stage3_ckpt" \
    --curve "$OUT/stage4" --save "$OUT/stage4_ckpt" 2>&1 | tail -20

$PY examples/train_ppo.py img_env_tpu/configs/baseline_10obs_5ped.yaml \
    --scenes "$S" --updates "${U5:-3000}" --unroll 16 --lr 3e-5 \
    --reward-scale 0.02 --ent-coef 0.0005 --force-sigma -2.0 \
    --restore "$OUT/stage4_ckpt" \
    --curve "$OUT/stage5" --save "$OUT/stage5_ckpt" 2>&1 | tail -20

$PY examples/evaluate.py img_env_tpu/configs/baseline_10obs_5ped.yaml \
    --episodes "${EVAL_EPISODES:-50}" --max-steps 100 \
    --policy ckpt --ckpt "$OUT/stage5_ckpt" \
    --bank "$OUT/bank.npz" --plots "$OUT/eval" 2>&1 | tail -20
