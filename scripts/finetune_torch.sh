#!/usr/bin/env bash
# Finetune launch of the PyTorch port (reference:
# Vidi1.5_9B/scripts/finetune.sh; the JAX launch is scripts/finetune.sh).
# deepspeed / ZeRO-3 becomes torchrun: NPROC ranks, each a ZeRO-3 slice of
# the parameters and moments, cut into a (data, seq, model) mesh by the
# sequence- and model-parallel sizes (data = NPROC / (SP x TP)).
# Hyperparameters keep the reference values (lr 1e-5 / mm_rand_lr 2e-5, wd
# 0.1, warmup 3%, loss_thres 0.1, seed 45678, mm_splits 4, save every 1000
# steps keeping 2). On CUDA the attention runs the kernels (--use_flash:
# K1 forward, K4 backward, K2 in the towers); DEVICE=cpu runs fp32 on gloo.
set -euo pipefail

MODEL_PATH=${MODEL_PATH:-}          # HF-format Vidi checkpoint dir; empty = --tiny
# Assembly from base checkpoints (reference finetune.sh:16-23): set both to
# start from a plain Gemma2 + local tower checkpoint dirs with fresh
# mm_rand_* adapters (mm_std matches finetune.sh:27).
VISION_TOWER=${VISION_TOWER:-}      # e.g. a local siglip2-so400m-patch14-384
AUDIO_TOWER=${AUDIO_TOWER:-}        # e.g. a local whisper-large-v3
DATA_PATH=${DATA_PATH:-example.json}
VIDEO_FOLDER=${VIDEO_FOLDER:-.}
OUTPUT_DIR=${OUTPUT_DIR:-checkpoint/vidi15-9b-finetune}
MAX_STEPS=${MAX_STEPS:-1000}
BS=${BS:-1}                         # per-rank batch
GA=${GA:-16}                        # gradient accumulation (finetune.sh GA arithmetic)
NPROC=${NPROC:-1}                   # ranks (cards) on this host
SP=${SP:-1}                         # sequence-parallel mesh size
TP=${TP:-1}                         # model-parallel mesh size
DEVICE=${DEVICE:-cuda}

MODEL_ARGS=()
if [[ -n "$MODEL_PATH" ]]; then
  MODEL_ARGS+=(--model_path "$MODEL_PATH")
else
  MODEL_ARGS+=(--tiny)
fi
if [[ -n "$VISION_TOWER" ]]; then
  [[ -n "$MODEL_PATH" ]] || {
    echo "VISION_TOWER requires MODEL_PATH (a plain Gemma2/Mistral dir to" \
         "assemble from)" >&2; exit 1; }
  MODEL_ARGS+=(--mm_vision_tower "$VISION_TOWER"
               --mm_image_pool_size 2
               --mm_input_type video
               --mm_std 0.028976401314139366)
  [[ -n "$AUDIO_TOWER" ]] && MODEL_ARGS+=(--mm_audio_tower "$AUDIO_TOWER"
                                          --mm_audio_pool_size 5)
fi
DEVICE_ARGS=(--device "$DEVICE")
if [[ "$DEVICE" == cuda ]]; then
  DEVICE_ARGS+=(--use_flash --dtype bfloat16)
else
  DEVICE_ARGS+=(--dtype float32)
fi

torchrun --standalone --nproc_per_node "$NPROC" -m vidi_tpu_torch.train.train \
  "${MODEL_ARGS[@]}" \
  "${DEVICE_ARGS[@]}" \
  --data_path "$DATA_PATH" \
  --video_folder "$VIDEO_FOLDER" \
  --output_dir "$OUTPUT_DIR" \
  --max_steps "$MAX_STEPS" \
  --per_device_train_batch_size "$BS" \
  --gradient_accumulation_steps "$GA" \
  --learning_rate 1e-5 \
  --mm_rand_lr 2e-5 \
  --weight_decay 0.1 \
  --warmup_ratio 0.03 \
  --loss_thres 0.1 \
  --mm_splits 4 \
  --save_steps 1000 \
  --save_total_limit 2 \
  --video_fps 1.0 \
  --seed 45678 \
  --group_by_length \
  --report_to tensorboard \
  --seq_parallel_size "$SP" \
  --model_parallel_size "$TP"
