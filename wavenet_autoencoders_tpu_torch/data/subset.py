"""ZeroSpeech-2019 layout scanner / subset maker (``mksubset_2019.py``; a
copy of ``wavenet_autoencoders_tpu/data/subset.py``).

Walks ``<in_dir>/<lan>/train/{unit,voice}/*.wav`` and ``<lan>/test/*.wav``,
takes a 1% dev split off the front of the sorted train list, writes the
per-split scp jsons ``[(src_wav, dst_dump_dir), ...]``, the speaker map
``2019_speaker2ind_<lan>.json`` (speaker = filename prefix before '_'), and
reports the global waveform min/max as gain advice.
"""
from __future__ import annotations

import json
from glob import glob
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def make_subset(language: str, in_dir: str, out_dir: str, scp_dir: str, dev_frac: float = 0.01):
    in_dir, out_dir, scp_dir = str(in_dir), str(out_dir), str(scp_dir)
    tr_dev = sorted(glob(f"{in_dir}/{language}/train/unit/*.wav")) + sorted(
        glob(f"{in_dir}/{language}/train/voice/*.wav")
    )
    test = sorted(glob(f"{in_dir}/{language}/test/*.wav"))
    dev_num = int(dev_frac * len(tr_dev))
    splits = {
        "train_no_dev": tr_dev[dev_num:],
        "dev": tr_dev[:dev_num],
        "test": test,
    }
    print(
        f"total number of train utts {len(splits['train_no_dev'])} "
        f"dev utts {len(splits['dev'])} test {len(splits['test'])}",
        flush=True,
    )
    Path(scp_dir).mkdir(parents=True, exist_ok=True)

    speakers: list[str] = []
    wav_min, wav_max = np.inf, -np.inf
    for split, files in splits.items():
        pairs = []
        for src in files:
            sp_fid = Path(src).name.split(".")[0]
            sp = sp_fid.split("_")[0]
            if split != "test":
                sr, x = wavfile.read(src)
                if x.dtype == np.int16:
                    x = x.astype(np.float32) / 2**15
                wav_min = min(wav_min, float(x.min(initial=np.inf)))
                wav_max = max(wav_max, float(x.max(initial=-np.inf)))
                if sp not in speakers:
                    speakers.append(sp)
            dst = f"{out_dir}/{language}/{split}/{sp_fid}/"
            Path(dst).mkdir(parents=True, exist_ok=True)
            pairs.append((src, dst))
        with open(f"{scp_dir}/{split}_src_dst.json", "w") as f:
            json.dump(pairs, f)

    sp2ind = {sp: i for i, sp in enumerate(speakers)}
    with open(f"{scp_dir}/2019_speaker2ind_{language}.json", "w") as f:
        json.dump(sp2ind, f)

    if np.isfinite(wav_min):
        absmax = max(abs(wav_min), abs(wav_max))
        print(f"Waveform min: {wav_min} max: {wav_max} absmax: {absmax}")
        if absmax > 1.0:
            print("There were clipping(s) in your dataset.")
        print(f"Global scaling factor would be around {1.0 / absmax}")
    return sp2ind
