#!/bin/bash
# train a model with the PyTorch port (bin/train.sh's arguments)
# usage: bin/torch/train.sh <preset> <dump_root> <ckpt_dir> [extra hparams]
set -e
PRESET=${1:?preset}
DUMP=${2:?dump root}
CKPT=${3:?checkpoint dir}
HP=${4:-}
python -m wavenet_autoencoders_tpu_torch.cli.main train --preset $PRESET \
    ${HP:+--hparams "$HP"} "$DUMP" "$CKPT" --dev-dump-root "${DUMP%/*}/dev"
