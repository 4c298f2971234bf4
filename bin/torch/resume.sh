#!/bin/bash
# resume training from the rolling latest checkpoint with the PyTorch port
# (bin/resume.sh's arguments; the port's entry points run on the GPU)
set -e
PRESET=${1:?preset}
DUMP=${2:?dump root}
CKPT=${3:?checkpoint dir}
python -m wavenet_autoencoders_tpu_torch.cli.main train --preset "$CKPT/config.json" \
    "$DUMP" "$CKPT" --checkpoint "$CKPT/checkpoint_latest.npz"
