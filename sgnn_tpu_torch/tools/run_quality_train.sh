#!/bin/bash
# Supervised quality-run trainer: the JAX package's
# tools/run_quality_train.sh recipe on the port's training CLI.
#
# Wraps python -m sgnn_tpu_torch.tools.train with:
#   - resume (--retrain auto picks the newest epoch checkpoint)
#   - restart on crash (per-epoch checkpoints make restarts cheap)
#   - a wall-clock deadline, so the card is freed for other work
#
# The recipe: batch 8, lr 0.001 decayed every 10 epochs, L=4 with 1000
# iterations per level of fade-in, the folded execution in bf16, batches
# shipped in bf16, row capacities sized from 48 sampled chunks. The JAX
# script's exit-75 rotation and --rss_restart_gb are not carried over
# (a workaround for its host's memory growth).
#
# Usage: run_quality_train.sh [deadline_seconds] [max_epoch] [run_dir]
#            [data_dir] [training CLI flags...]
# data_dir holds chunks/, chunks_train.txt and chunks_val.txt; run_dir
# receives the checkpoints and logs; flags after the four positional
# arguments are appended to the recipe's (a later flag wins: --cpu and a
# smaller model rehearse the script on the host). FUSE_TRAIN_BN=0 trains the composed
# BN -> op ablation, MAX_TRIES caps the attempts (12), PYTHON names the
# interpreter (python3). Exits 0 when training completed or the deadline
# came, 1 after MAX_TRIES failed attempts.
set -u
DEADLINE=${1:-9000}
MAX_EPOCH=${2:-60}
RUN=${3:-logs/quality}
DATA=${4:-data/synth}
MAX_TRIES=${MAX_TRIES:-12}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
START=$(date +%s)
TRIES=0
while :; do
  NOW=$(date +%s); LEFT=$((DEADLINE - (NOW - START)))
  if [ "$LEFT" -le 120 ]; then echo "[supervisor] deadline reached"; break; fi
  if [ "$TRIES" -ge "$MAX_TRIES" ]; then
    echo "[supervisor] too many restarts"; exit 1
  fi
  TRIES=$((TRIES + 1))
  echo "[supervisor] attempt $TRIES, ${LEFT}s left"
  timeout "$LEFT" "${PYTHON:-python3}" -m sgnn_tpu_torch.tools.train \
    --data_path "$DATA/chunks" \
    --train_file_list "$DATA/chunks_train.txt" \
    --val_file_list "$DATA/chunks_val.txt" \
    --save "$RUN" --retrain auto \
    --max_epoch "$MAX_EPOCH" --save_epoch 1 \
    --batch_size 8 --lr 0.001 --decay_lr 10 \
    --num_hierarchy_levels 4 --num_iters_per_level 1000 \
    --fuse_train_bn "${FUSE_TRAIN_BN:-1}" \
    --execution folded --compute_dtype bfloat16 \
    --transfer_dtype bfloat16 \
    --autotune_capacity 48 "${@:5}"
  RC=$?
  if [ "$RC" -eq 0 ]; then echo "[supervisor] training completed"; break; fi
  echo "[supervisor] train exited rc=$RC; restarting from latest ckpt"
  sleep 5
done
echo "[supervisor] done"
