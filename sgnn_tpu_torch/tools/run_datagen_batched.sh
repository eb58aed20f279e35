#!/bin/bash
# The batched synthetic-dataset pipeline with the port's CLIs, for a
# corpus larger than the disk holds as scene volumes.
#   sgnn_tpu_torch/tools/run_datagen_batched.sh [OUT] [NUM_SCENES] [BATCH]
# OUT (default data/synth) is relative to the repository root.
#
# Same stages as run_datagen_pipeline.sh, but scans+chunks run in
# batches of scenes and each batch's TRAIN-scene volumes (complete/
# incomplete .sdf intermediates, ~105 MB/scene) are deleted once their
# chunks exist. Val-scene volumes are kept: the scene evaluation
# (python -m sgnn_tpu_torch.tools.evaluate) needs them.
# Stages resume if interrupted (existing chunks lists are kept).
set -e
cd "$(dirname "$0")/../.."
OUT=${1:-data/synth}
N=${2:-352}
BATCH=${3:-32}
mkdir -p "$OUT"

if [ ! -f "$OUT/scenes.txt" ]; then
  python -m sgnn_tpu_torch.tools.make_synthetic_scenes --out "$OUT" --num_scenes "$N" --frames 40
fi

: > "$OUT/chunks_train.txt.tmp"
: > "$OUT/chunks_val.txt.tmp"
mkdir -p "$OUT/batches"
split -l "$BATCH" -d -a 3 "$OUT/scenes.txt" "$OUT/batches/scenes_"

for BF in "$OUT"/batches/scenes_*; do
  BN=$(basename "$BF")
  DONE="$OUT/batches/$BN.done"
  # resume: completed batches keep their chunk lists next to the marker
  if [ -f "$DONE" ]; then
    cat "$OUT/batches/$BN.chunks_train" >> "$OUT/chunks_train.txt.tmp" 2>/dev/null || true
    cat "$OUT/batches/$BN.chunks_val" >> "$OUT/chunks_val.txt.tmp" 2>/dev/null || true
    continue
  fi
  echo "== batch $BN: $(wc -l < "$BF") scenes"
  python -m sgnn_tpu_torch.tools.generate_scans \
    --scan_path "$OUT/scans" --scan_mesh_path "$OUT/meshes" \
    --scene_file_list "$BF" \
    --output_complete "$OUT/complete" --output_incomplete "$OUT/incomplete" \
    --incomplete_frame_path "$OUT/frames"
  # split this batch into train/val by membership in scenes_val.txt
  grep -Fxf "$OUT/scenes_val.txt" "$BF" > "$BF.val" || true
  grep -Fvxf "$OUT/scenes_val.txt" "$BF" > "$BF.train" || true
  if [ -s "$BF.train" ]; then
    python -m sgnn_tpu_torch.tools.make_chunks \
      --input_data_path "$OUT/incomplete" --target_data_path "$OUT/complete" \
      --scene_file_list "$BF.train" \
      --output "$OUT/chunks" --list_out "$OUT/batches/$BN.chunks_train"
    cat "$OUT/batches/$BN.chunks_train" >> "$OUT/chunks_train.txt.tmp"
    # train volumes served their purpose; reclaim the disk
    while read -r S; do
      rm -f "$OUT/complete/$S"__0__.sdf "$OUT/complete/$S"__0__.knw \
            "$OUT/incomplete/$S"__0__.sdf
    done < "$BF.train"
  fi
  if [ -s "$BF.val" ]; then
    python -m sgnn_tpu_torch.tools.make_chunks \
      --input_data_path "$OUT/incomplete" --target_data_path "$OUT/complete" \
      --scene_file_list "$BF.val" \
      --output "$OUT/chunks" --list_out "$OUT/batches/$BN.chunks_val"
    cat "$OUT/batches/$BN.chunks_val" >> "$OUT/chunks_val.txt.tmp"
  fi
  touch "$DONE"
  echo "== batch $BN done ($(date +%H:%M:%S)), disk: $(df -h "$OUT" | awk 'NR==2{print $4}') free"
done

mv "$OUT/chunks_train.txt.tmp" "$OUT/chunks_train.txt"
mv "$OUT/chunks_val.txt.tmp" "$OUT/chunks_val.txt"
echo "PIPELINE DONE: $(wc -l < "$OUT/chunks_train.txt") train / $(wc -l < "$OUT/chunks_val.txt") val chunks"
