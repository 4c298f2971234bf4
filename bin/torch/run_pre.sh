#!/bin/bash
# 4-stage preprocessing pipeline with the PyTorch port (bin/run_pre.sh's
# arguments and stages; host only, writes the same files).
# usage: bin/torch/run_pre.sh <language> <zs2019_root> [preset]
set -e
LAN=${1:-english}
RAW=${2:?zs2019 root}
PRESET=${3:-svqwae}
STAGE_START=${STAGE_START:-1}
STAGE_END=${STAGE_END:-4}

DUMP=dump/2019/
SCP=scp/2019
CLI="python -m wavenet_autoencoders_tpu_torch.cli.main"

if [ $STAGE_START -le 1 ] && [ $STAGE_END -ge 1 ]; then
  $CLI subset $LAN $RAW $DUMP $SCP
fi
if [ $STAGE_START -le 2 ] && [ $STAGE_END -ge 2 ]; then
  for split in train_no_dev dev test; do
    $CLI preprocess --preset $PRESET $SCP/${split}_src_dst.json \
        $DUMP/$LAN/$split $SCP/2019_speaker2ind_${LAN}.json
  done
fi
if [ $STAGE_START -le 3 ] && [ $STAGE_END -ge 3 ]; then
  $CLI cmvn mfcc cmvn_${LAN}.npz $SCP/train_no_dev_src_dst.json
fi
if [ $STAGE_START -le 4 ] && [ $STAGE_END -ge 4 ]; then
  for split in train_no_dev dev test; do
    $CLI normalize $SCP/${split}_src_dst.json mfcc cmvn_${LAN}.npz
  done
fi
