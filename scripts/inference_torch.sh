#!/usr/bin/env bash
# Single-video inference entry of the PyTorch port (reference:
# Vidi1.5_9B/scripts/inference.sh; the JAX entry is scripts/inference.sh).
# The model path is an HF-format Vidi checkpoint directory (a released one,
# or one written by the port's save_pretrained / train --export_hf). On a
# CUDA card the encoders and prefill run the attention kernels
# (vidi_tpu_torch/csrc); pass --load-8bit / --load-4bit to shrink the text
# decoder's weights. DEVICE=cpu runs the plain PyTorch versions in fp32.
set -euo pipefail

VIDEO_PATH=${VIDEO_PATH:-"Your Video Path"}
QUERY=${QUERY:-"Your Query"}
MODEL_PATH=${MODEL_PATH:-"Your Model Path"}
DEVICE=${DEVICE:-cuda}
DTYPE=bfloat16
[[ "$DEVICE" == cpu ]] && DTYPE=float32

python3 -u -m vidi_tpu_torch.infer.pipeline \
    --video-path "$VIDEO_PATH" \
    --query "$QUERY" \
    --model-path "$MODEL_PATH" \
    --device "$DEVICE" \
    --dtype "$DTYPE"
