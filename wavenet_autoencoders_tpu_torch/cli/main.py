"""Command-line entry points of the port (counterpart of
``wavenet_autoencoders_tpu/cli/main.py``), from wav files to a validated
submission:

    subset      scan a ZeroSpeech-2019 tree, write scp jsons + speaker map
    preprocess  extract wave/mel/mfcc npys per utterance
    cmvn        fit mean/var stats over dumped features
    normalize   apply (or invert) CMVN -> <feat>.norm.npy
    train       train a model (single process), npz checkpoints; with
                ``--dev-dump-root`` a dev pass each epoch
    infer       ABX representation export
    synthesize  voice-conversion synthesis
    validate    sanity-check a submission tree

The data-preparation subcommands run on the host (numpy/scipy) and write
the same files as the JAX package's. Checkpoints are in the JAX package's
npz format (leaves keyed ``params/<tree path>``, ``opt_state/...``), so
either package reads the other's. The model subcommands run on
``--device`` (default ``cuda``).
Run as ``python -m wavenet_autoencoders_tpu_torch.cli.main <cmd> ...``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from wavenet_autoencoders_tpu_torch.config import Config, load_preset


def _cfg_from(args) -> Config:
    if args.preset:
        return load_preset(args.preset, args.hparams or "")
    return Config().parse(args.hparams or "")


def _add_preset(p):
    p.add_argument("--preset", help="bundled preset name or JSON path")
    p.add_argument("--hparams", default="", help='overrides: "k=v,k2=[..]"')


def _add_cfg(p):
    _add_preset(p)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")


def _add_common(p):
    _add_cfg(p)
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default="auto",
                   help="load the *_ema checkpoint sibling; --no-use-ema uses raw weights "
                        "(default: only once the EMA shadow is warm)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="wae-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("subset", help="scan ZS2019 layout, write scp jsons + speaker map")
    p.add_argument("language")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("scp_dir")

    p = sub.add_parser("preprocess", help="extract wave/mel/mfcc npys per utterance")
    _add_preset(p)
    p.add_argument("scp")
    p.add_argument("out_dir")
    p.add_argument("sp2ind")
    p.add_argument("--num-workers", type=int, default=None)

    p = sub.add_parser("cmvn", help="fit mean/var stats over dumped features")
    p.add_argument("feat")
    p.add_argument("scaler_out")
    p.add_argument("scps", nargs="+")

    p = sub.add_parser("normalize", help="apply (or invert) CMVN -> <feat>.norm.npy")
    p.add_argument("scp")
    p.add_argument("feat")
    p.add_argument("scaler")
    p.add_argument("--inverse", action="store_true")

    p = sub.add_parser("train", help="train a model")
    _add_cfg(p)
    p.add_argument("dump_root")
    p.add_argument("checkpoint_dir")
    p.add_argument("--dev-dump-root", default=None, help="dev split dump (a dev pass every dev_epoch_interval epochs)")
    p.add_argument("--checkpoint", default=None, help="resume checkpoint")
    p.add_argument("--restore-parts", default=None, help="partial, shape-tolerant weight load")
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--feat-type", default="mfcc")
    p.add_argument("--max-steps", type=int, default=None)

    p = sub.add_parser("infer", help="export ABX representations")
    _add_common(p)
    p.add_argument("checkpoint")
    p.add_argument("scp")
    p.add_argument("dst_dir")
    p.add_argument("--feat", default="mfcc.norm")
    p.add_argument("--lan", default=None, help="submission language dir (else inferred from dump paths)")
    p.add_argument("--pre-vq", action="store_true",
                   help="export the continuous pre-quantization latent (VQ models only)")

    p = sub.add_parser("synthesize", help="voice-conversion synthesis")
    _add_common(p)
    p.add_argument("checkpoint")
    p.add_argument("dump_root")
    p.add_argument("dst_dir")
    p.add_argument("syn_list")
    p.add_argument("speaker2ind")
    p.add_argument("lan")
    p.add_argument("--start-ind", type=int, default=0)
    p.add_argument("--tar-utt-map", default=None, help="json: speaker -> mfcc.norm.npy for AdaIN")
    p.add_argument("--train-dump-root", default=None, help="train_no_dev dump dir for auto tar_c selection")
    p.add_argument("--batch", type=int, default=1, help="utterances decoded in parallel")
    p.add_argument("--pad-frames-multiple", type=int, default=0,
                   help="bucket conditioning lengths to a multiple of N frames "
                        "(edge-replicated, cropped back); 0 = exact lengths")

    p = sub.add_parser("validate", help="sanity-check a ZeroSpeech-2019 submission tree")
    p.add_argument("submission_dir")
    p.add_argument("--lan", default="english")

    args = ap.parse_args(argv)
    if args.cmd == "subset":
        from wavenet_autoencoders_tpu_torch.data.subset import make_subset

        make_subset(args.language, args.in_dir, args.out_dir, args.scp_dir)
        return
    if args.cmd == "cmvn":
        from wavenet_autoencoders_tpu_torch.data.normalize import compute_mean_var

        compute_mean_var(args.scps, args.feat, args.scaler_out)
        return
    if args.cmd == "normalize":
        from wavenet_autoencoders_tpu_torch.data.normalize import apply_normalization

        apply_normalization(args.scp, args.feat, args.scaler, inverse=args.inverse)
        return
    if args.cmd == "validate":
        from wavenet_autoencoders_tpu_torch.eval.validate import validate_submission

        summary = validate_submission(args.submission_dir, lan=args.lan)
        print(f"submission OK: {summary}")
        return
    cfg = _cfg_from(args)
    if args.cmd == "preprocess":
        from wavenet_autoencoders_tpu_torch.data.preprocess import preprocess

        print(f"Sampling frequency: {cfg.sample_rate}")
        preprocess(cfg, args.scp, args.out_dir, args.sp2ind, num_workers=args.num_workers)
        return
    if args.cmd == "train":
        from wavenet_autoencoders_tpu_torch.train.loop import train

        train(
            cfg, args.dump_root, args.checkpoint_dir, resume=args.checkpoint,
            restore_parts_from=args.restore_parts, reset_optimizer=args.reset_optimizer,
            feat_type=args.feat_type, max_steps=args.max_steps, dev_dump_root=args.dev_dump_root,
            device=args.device,
        )
        return
    model = _load_model(cfg, args.checkpoint, use_ema=args.use_ema, device=args.device)
    if args.cmd == "infer":
        from wavenet_autoencoders_tpu_torch.eval.infer import export_representations

        export_representations(
            cfg, model, args.scp, args.dst_dir, feat=args.feat, lan=args.lan,
            pre_vq=args.pre_vq, device=args.device,
        )
    elif args.cmd == "synthesize":
        from wavenet_autoencoders_tpu_torch.eval.synthesize import run_synthesis_list

        tar_map = json.load(open(args.tar_utt_map)) if args.tar_utt_map else None
        run_synthesis_list(
            cfg, model, args.dump_root, args.syn_list, args.speaker2ind, args.dst_dir,
            lan=args.lan, start_ind=args.start_ind, tar_utt_map=tar_map, batch=args.batch,
            train_dump_root=args.train_dump_root, pad_multiple=args.pad_frames_multiple,
            device=args.device,
        )


def _load_model(cfg: Config, checkpoint: str, use_ema: bool | str = "auto", device="cuda"):
    """Build the model from cfg on ``device`` and load the npz checkpoint.

    ``use_ema=True`` prefers the *_ema sibling; ``"auto"`` does so only once
    the shadow has warmed (checkpoint step >= ema_warm_steps)."""
    from wavenet_autoencoders_tpu_torch.models.zoo import build_model
    from wavenet_autoencoders_tpu_torch.train.step import ema_warm_steps
    from wavenet_autoencoders_tpu_torch.utils.params import load_flat_params

    model = build_model(cfg, device=device)
    path = checkpoint
    if use_ema == "auto":
        try:
            step = int(np.load(checkpoint)["step"])
        except (KeyError, FileNotFoundError):
            step = 0
        use_ema = step >= ema_warm_steps(cfg.ema_decay)
        if not use_ema:
            print(f"ema shadow not warm at step {step} "
                  f"(< {ema_warm_steps(cfg.ema_decay)}); evaluating live params")
    if use_ema:
        ema_path = str(checkpoint).replace(".npz", "_ema.npz")
        if Path(ema_path).exists() and not str(checkpoint).endswith("_ema.npz"):
            path = ema_path
    load_flat_params(model, np.load(path), prefix="params/")
    print(f"loaded checkpoint {path}")
    return model


if __name__ == "__main__":
    main()
