#!/usr/bin/env bash
# Multi-card testing launcher (reference surface: scripts/dist_test.sh).
# See dist_train.sh: one process per card under torchrun.
#
#   ./ssl_tpu_torch/scripts/dist_test.sh 2 options/test/ESRGANSSL/test_ESRGANSSL_bicubic_x4.yml

GPUS=$1
CONFIG=$2
if [ $# -lt 2 ]; then
    echo "usage: ./ssl_tpu_torch/scripts/dist_test.sh [number of cards] [path to option file] [extra args...]"
    exit 1
fi
PYTHONPATH="$(dirname "$0")/../..:${PYTHONPATH}" \
torchrun --standalone --nproc_per_node="$GPUS" \
    -m ssl_tpu_torch.test -opt "$CONFIG" --launcher pytorch "${@:3}"
