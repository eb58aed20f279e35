#!/bin/bash
# The synthetic-dataset pipeline with the port's CLIs: rooms, fused
# scene pairs, then train and val chunks. Stages resume if interrupted.
#   sgnn_tpu_torch/tools/run_datagen_pipeline.sh [OUT] [NUM_SCENES]
# OUT (default data/synth) is relative to the repository root.
set -e
cd "$(dirname "$0")/../.."
OUT=${1:-data/synth}
N=${2:-160}
python -m sgnn_tpu_torch.tools.make_synthetic_scenes --out "$OUT" --num_scenes "$N" --frames 40
python -m sgnn_tpu_torch.tools.generate_scans \
  --scan_path "$OUT/scans" --scan_mesh_path "$OUT/meshes" \
  --scene_file_list "$OUT/scenes.txt" \
  --output_complete "$OUT/complete" --output_incomplete "$OUT/incomplete" \
  --incomplete_frame_path "$OUT/frames"
python -m sgnn_tpu_torch.tools.make_chunks \
  --input_data_path "$OUT/incomplete" --target_data_path "$OUT/complete" \
  --scene_file_list "$OUT/scenes_train.txt" \
  --output "$OUT/chunks" --list_out "$OUT/chunks_train.txt"
python -m sgnn_tpu_torch.tools.make_chunks \
  --input_data_path "$OUT/incomplete" --target_data_path "$OUT/complete" \
  --scene_file_list "$OUT/scenes_val.txt" \
  --output "$OUT/chunks" --list_out "$OUT/chunks_val.txt"
echo "PIPELINE DONE: $(wc -l < "$OUT/chunks_train.txt") train / $(wc -l < "$OUT/chunks_val.txt") val chunks"
