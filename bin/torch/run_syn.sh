#!/bin/bash
# voice-conversion synthesis with the PyTorch port (bin/run_syn.sh's
# arguments)
set -e
CKPT_DIR=${1:?experiment dir}
DUMP=${2:?dump root}
DST=${3:?output dir}
SYN_LIST=${4:?synthesis.txt}
SP2IND=${5:?speaker2ind json}
LAN=${6:-english}
START=${7:-0}
python -m wavenet_autoencoders_tpu_torch.cli.main synthesize \
    --preset "$CKPT_DIR/config.json" \
    "$CKPT_DIR/checkpoint_latest.npz" "$DUMP" "$DST" "$SYN_LIST" "$SP2IND" "$LAN" \
    --start-ind "$START"
