#!/usr/bin/env bash
# Multi-card training launcher (reference surface: scripts/dist_train.sh).
#
# One process per card under torchrun, NCCL between them (gloo with
# --device cpu):
#
#   ./ssl_tpu_torch/scripts/dist_train.sh 4 options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml
#
# Extra arguments go to the training CLI (e.g. --auto_resume, --device cpu).

GPUS=$1
CONFIG=$2
if [ $# -lt 2 ]; then
    echo "usage: ./ssl_tpu_torch/scripts/dist_train.sh [number of cards] [path to option file] [extra args...]"
    exit 1
fi
PYTHONPATH="$(dirname "$0")/../..:${PYTHONPATH}" \
torchrun --standalone --nproc_per_node="$GPUS" \
    -m ssl_tpu_torch.train -opt "$CONFIG" --launcher pytorch "${@:3}"
