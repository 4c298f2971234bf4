#!/bin/bash
# ABX representation export with the PyTorch port (bin/run_infer19.sh's
# arguments): reuses the experiment's frozen config.json.
set -e
CKPT_DIR=${1:?experiment dir}
SCP=${2:?test scp json}
DST=${3:?output dir}
python -m wavenet_autoencoders_tpu_torch.cli.main infer \
    --preset "$CKPT_DIR/config.json" \
    "$CKPT_DIR/checkpoint_latest.npz" "$SCP" "$DST"
