#!/bin/bash
# ZeroSpeech 2019 evaluation with the PyTorch port (bin/run_eval19.sh's
# arguments and stages). The evaluator itself is the external
# bootphon/zerospeech2020 toolkit; the port produces its exact input formats
# (ABX txt from bin/torch/run_infer19.sh, wavs from bin/torch/run_syn.sh).
set -e
SUBMISSION=${1:?submission dir}
OUT=${2:-res}
# structural/format pre-check (works offline)
python -m wavenet_autoencoders_tpu_torch.cli.main validate "$SUBMISSION"
command -v zerospeech2020-validate >/dev/null || {
  echo "zerospeech2020 toolkit not installed (external dependency)"; exit 1; }
zerospeech2020-validate "$SUBMISSION"
mkdir -p "$OUT"
zerospeech2020-evaluate 2019 -j10 "$SUBMISSION" -o "$OUT/eval.json"
