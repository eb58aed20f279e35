#!/bin/bash
# Post-training evaluation of a quality run (run_quality_train.sh), the
# JAX package's tools/eval_quality_run.sh on the port's CLIs:
#   1. convergence table from the CSV logs
#   2. whole-scene inference and meshes on held-out val scenes
#   3. scene-level metrics (evaluate) with the trained checkpoint
#   4. the converter round trip on the trained checkpoint:
#      .ckpt -> .pth -> .ckpt -> .pth, the two .pth files byte for byte
#      (a .ckpt's zip entries carry their write time; a .pth holds all
#      that the .ckpt -> .pth direction keeps: weights, BN stats, epoch)
#
# Usage: eval_quality_run.sh [run_dir] [data_dir] [ckpt] [out_dir]
#            [scene CLI flags...]
# data_dir holds incomplete/, complete/ and scenes_val.txt. The forwards
# run on the card; flags after the four positional arguments go to the
# scene and evaluate CLIs (--cpu runs them on the host), NET_ARGS (the
# architecture's flags, the training CLI's defaults when empty) to them
# and to the converter. PYTHON names the interpreter (python3).
set -e
RUN=${1:-logs/quality}
DATA=${2:-data/synth}
# prefer the final per-epoch checkpoint (numerically last), not the
# newest by mtime (which can be a mid-epoch iter snapshot)
_default_ckpt() {
  local best
  best=$(ls "$RUN"/model-epoch-*.ckpt 2>/dev/null | sort -t- -k3 -n | tail -1)
  [ -n "$best" ] && { echo "$best"; return; }
  ls -t "$RUN"/*.ckpt | head -1
}
CKPT=${3:-$(_default_ckpt)}
OUT=${4:-$RUN/eval}
PY=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

echo "== checkpoint: $CKPT"
"$PY" -m sgnn_tpu_torch.tools.summarize_train "$RUN"

echo "== scene inference + meshes (held-out val scenes)"
"$PY" -m sgnn_tpu_torch.tools.test_scene \
  --input_data_path "$DATA/incomplete" --target_data_path "$DATA/complete" \
  --test_file_list "$DATA/scenes_val.txt" --model_path "$CKPT" \
  --output "$OUT/scenes" --max_to_vis 6 --dim_round 32 128 128 \
  --execution folded --compute_dtype bfloat16 ${NET_ARGS:-} "${@:5}"

echo "== scene-level metrics"
"$PY" -m sgnn_tpu_torch.tools.evaluate \
  --input_data_path "$DATA/incomplete" --target_data_path "$DATA/complete" \
  --test_file_list "$DATA/scenes_val.txt" --model_path "$CKPT" \
  --max_scenes 6 --execution folded --compute_dtype bfloat16 \
  --dim_round 32 128 128 \
  --output "$OUT/metrics.json" ${NET_ARGS:-} "${@:5}"
cat "$OUT/metrics.json"

echo "== converter round trip on trained weights"
RT="$OUT/roundtrip"
mkdir -p "$RT/a" "$RT/b"
"$PY" -m sgnn_tpu_torch.tools.convert_checkpoint \
  --input "$CKPT" --output "$RT/a/model.pth" ${NET_ARGS:-}
"$PY" -m sgnn_tpu_torch.tools.convert_checkpoint \
  --input "$RT/a/model.pth" --output "$RT/model.ckpt" ${NET_ARGS:-}
"$PY" -m sgnn_tpu_torch.tools.convert_checkpoint \
  --input "$RT/model.ckpt" --output "$RT/b/model.pth" ${NET_ARGS:-}
cmp "$RT/a/model.pth" "$RT/b/model.pth"
echo "round trip: byte-identical"
