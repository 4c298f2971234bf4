"""Typed experiment configuration (the PyTorch port's own copy of the JAX
package's ``config.py``; same fields, same presets, same override grammar).

Replaces the reference's three-tier config stack (defaults in
``hparams.py:8-135``, JSON presets in ``hps/*.json``, and the vendored
TF-HParams ``--hparams "k=v,..."`` override grammar in
``tfcompat/hparam.py:190-280,523``) with a single dataclass.

Precedence (identical to reference ``vqwae_train.py:1088-1092``):
    defaults < JSON preset < "k=v" override string.

The resolved config is frozen into ``<ckpt_dir>/config.json`` at train start
and reused by inference/synthesis — the reproducibility contract of
``vqwae_train.py:1100-1102`` + ``bin/run_infer19.sh:12``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# Grammar of the override string, e.g.:
#   "batch_size=8,lr_schedule_kwargs={...},upsample_scales=[4,4,8,5]"
# Mirrors PARAM_RE of tfcompat/hparam.py:36-43.
_PARAM_RE = re.compile(
    r"""
    (?P<name>[a-zA-Z][\w\.]*)      # variable name
    \s*=\s*
    ((?P<val>[^,\[{]*)             # single value
     |\[(?P<vals>[^\]]*)\]         # list of values
     |(?P<json>\{[^}]*\})          # json object
    )($|,\s*)""",
    re.VERBOSE,
)


def _coerce(raw: str, like: Any) -> Any:
    raw = raw.strip()
    if like is None or isinstance(like, str):
        if raw.lower() in ("true", "false"):
            return raw.lower() == "true"
        if raw.lower() in ("none", "null"):
            return None
        return raw
    if isinstance(like, bool):
        if raw.lower() in ("true", "1"):
            return True
        if raw.lower() in ("false", "0"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(like, int) and not isinstance(like, bool):
        if raw.lower() in ("none", "null"):
            return None
        return int(raw)
    if isinstance(like, float):
        if raw.lower() in ("none", "null"):
            return None
        return float(raw)
    return raw


def _parse_scalar(raw: str) -> Any:
    raw = raw.strip()
    for caster in (int, float):
        try:
            return caster(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.lower() in ("none", "null"):
        return None
    return raw


@dataclass
class Config:
    """Union of every hyperparameter the reference threads through its model
    zoo (``hparams.py`` defaults + per-model flags from ``hps/*.json``,
    e.g. ``hps/vqwae.json``, ``hps/inae_hp.json``, ``hps/catae_hp.json``)."""

    # ---- identity ----
    name: str = "wavenet_vocoder"  # dispatch key: wvae|vqvae|inae|inae1|new_inae|catae|...
    language: str = "english"

    # ---- waveform input representation (hparams.py:20-21) ----
    input_type: str = "raw"  # raw | mulaw | mulaw-quantize
    quantize_channels: int = 65536

    # ---- time-domain pre/post processing (hparams.py:27-30) ----
    preprocess: str = ""          # "" | "preemphasis"
    postprocess: str = ""         # "" | "inv_preemphasis"
    global_gain_scale: float = 1.0
    preemphasis_coef: float = 0.85

    # ---- audio analysis (hparams.py:32-48) ----
    sample_rate: int = 22050
    silence_threshold: int = 2
    num_mels: int = 80
    n_mfcc: int = 13
    fmin: float = 125.0
    fmax: float = 7600.0
    fft_size: int = 1024
    hop_size: int = 256
    frame_shift_ms: float | None = None
    win_length: int = 1024
    win_length_ms: float = -1.0
    window: str = "hann"
    min_level_db: int = -100
    highpass_cutoff: float = 70.0

    # ---- output distribution (hparams.py:52-53) ----
    output_distribution: str = "Logistic"  # Logistic | Normal
    log_scale_min: float = -16.0

    # ---- WaveNet decoder architecture (hparams.py:59-66) ----
    out_channels: int = 30
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 128
    gate_channels: int = 256
    skip_out_channels: int = 128
    dropout: float = 0.0
    kernel_size: int = 3

    # ---- local conditioning (hparams.py:69-77) ----
    cin_channels: int = 80
    cin_pad: int = 2
    upsample_conditional_features: bool = True
    upsample_net: str = "ConvInUpsampleNetwork"
    upsample_params: dict = field(
        default_factory=lambda: {"upsample_scales": [4, 4, 4, 4]}
    )

    # ---- global conditioning (hparams.py:82-83) ----
    gin_channels: int = -1
    n_speakers: int = 7
    use_speaker_embedding: bool = True

    # ---- data loading (hparams.py:86-87) ----
    pin_memory: bool = True
    num_workers: int = 2

    # ---- optimization (hparams.py:92-108) ----
    batch_size: int = 8
    dev_batch_size: int = 1
    optimizer: str = "Adam"
    optimizer_params: dict = field(
        default_factory=lambda: {"lr": 1e-3, "eps": 1e-8, "weight_decay": 0.0}
    )
    lr_schedule: str = "step_learning_rate_decay"
    lr_schedule_kwargs: dict = field(
        default_factory=lambda: {"anneal_rate": 0.5, "anneal_interval": 200000}
    )
    max_train_steps: int = 1000000
    nepochs: int = 2000
    clip_thresh: float = -1

    # ---- batching / cropping (hparams.py:112-113) ----
    max_time_sec: float | None = None
    max_time_steps: int | None = 10240

    # ---- parameter EMA (hparams.py:116-118) ----
    exponential_moving_average: bool = True
    ema_decay: float = 0.9999

    # ---- checkpointing cadence (hparams.py:122-126) ----
    checkpoint_interval: int = 100000
    train_eval_interval: int = 100000
    test_eval_epoch_interval: int = 50
    # full dev pass every N epochs (reference: every epoch,
    # vqwae_train.py:823-875 — raise on corpora whose epochs are tiny)
    dev_epoch_interval: int = 1
    save_optimizer_state: bool = True

    # ---- autoencoder family (hparams.py:129-134 + hps/*.json flags) ----
    dim_in: int = 39              # MFCC(13)+Δ+ΔΔ input feature dim
    encoder_hid: int = 384        # encoder hidden width
    frame_rate: int = 25          # latent frame rate (25 or 50 Hz)
    K: int = 256                  # codebook size (slice 1)
    K1: int | None = None         # codebook size for slice 2 (asymmetric SVQ)
    use_K1: bool = False
    num_slices: int = 2           # SVQ slice count
    ema: bool = False             # EMA codebook updates
    sliced: bool = False          # sliced VQ bottleneck
    ins_norm: bool = False        # instance-norm before quantization
    post_conv: bool = False       # post-bottleneck projection conv
    adain: bool = False           # AdaIN speaker re-styling
    time_jitter: bool = False     # Chorowski time-jitter regularizer
    time_jitter_prob: float = 0.12
    # True (default) replaces each latent frame by its left/right neighbour
    # with prob `time_jitter_prob` PER SIDE (total 2*prob) — a documented
    # deviation kept for continuity with earlier checkpoints of this repo;
    # False matches Chorowski et al.: replaced with total prob
    # `time_jitter_prob`, direction uniform. (The upstream model is
    # gitignored, so the reference reading is unrecoverable.)
    time_jitter_per_side: bool = True
    # delay jitter until this step (0 = reference behavior, always on):
    # round-4 run E showed jitter active during the commitment warm-up
    # re-collapses the codebook; gating it past the warm-up keeps the
    # regularizer without the early-training interaction
    time_jitter_start: int = 0
    vq_drop: bool = False         # VQ dropout
    drop_dim: int = 0
    beta: float = 0.25            # VQ commitment weight
    # scale on the sliced-VQ encoder-pull term (sg(q)-z)^2; 1.0 = reference
    # parity (the reference hardcodes it) - see bottlenecks.sliced_vq_apply
    vq_commit_scale: float = 1.0
    # ---- anti-collapse levers (new; rounds 1-3 showed the reference's
    # Laplace smoothing alone does not keep the codebook alive) ----
    vq_reseed: bool = False       # dead-code revival (bottlenecks.reseed_slice)
    vq_reseed_thresh: float = 0.1 # dead if usage EMA < thresh/K (frac of uniform)
    vq_reseed_decay: float = 0.99 # usage EMA decay
    vq_reseed_start: int = 500    # first step revival may fire
    vq_warmup_steps: int = 0      # linear 0->1 ramp on the VQ aux loss
    collapse_min_perplexity: float = 0.0  # abort run if perp EMA below this...
    collapse_check_step: int = 0          # ...at/after this step (0 = off)
    hard: bool = False            # hard Gumbel-softmax (CatWavAE)
    tau: float = 0.1              # Gumbel-softmax temperature

    # ---- TPU-specific (new in this framework) ----
    mesh_shape: dict = field(default_factory=lambda: {"data": -1, "model": 1})
    compute_dtype: str = "bfloat16"   # activations dtype in matmul-heavy paths
    fused_stack: bool = False         # whole-stack Pallas fwd+bwd GLU kernel
    param_dtype: str = "float32"
    seed: int = 1234
    profile_dir: str | None = None    # profiler trace output

    # Unknown preset keys land here instead of raising, so presets written for
    # newer revisions of the reference keep loading.
    extras: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def values(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extras")
        d.update(self.extras)
        return d

    # -- JSON preset layer (parse_json parity, tfcompat/hparam.py:594) --
    def parse_json(self, text: str) -> "Config":
        return self.override(json.loads(text))

    def override(self, mapping: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(self)}
        updates, extras = {}, dict(self.extras)
        for k, v in mapping.items():
            if k in known and k != "extras":
                updates[k] = v
            else:
                extras[k] = v
        updates["extras"] = extras
        return dataclasses.replace(self, **updates)

    # -- "k=v,..." override layer (parse parity, tfcompat/hparam.py:523) --
    def parse(self, spec: str) -> "Config":
        """CLI override string. Unknown keys RAISE, like the vendored TF
        HParams (``tfcompat/hparam.py:548-551``) — a typo'd override must
        not silently train with defaults. Preset *files* stay tolerant
        (unknown JSON keys land in ``extras``, see ``override``)."""
        if not spec:
            return self
        known = {f.name for f in dataclasses.fields(self)} - {"extras"}
        pos, updates = 0, {}
        while pos < len(spec):
            m = _PARAM_RE.match(spec, pos)
            if not m:
                raise ValueError(f"malformed hyperparameter string: {spec[pos:]!r}")
            pos = m.end()
            name = m.group("name")
            if name not in known:
                raise ValueError(
                    f"unknown hyperparameter {name!r} in override string "
                    "(CLI overrides accept known keys only; put experimental "
                    "keys in a preset JSON, where they land in extras)"
                )
            current = getattr(self, name, None)
            if m.group("json") is not None:
                updates[name] = json.loads(m.group("json"))
            elif m.group("vals") is not None:
                items = [s for s in m.group("vals").split(",") if s.strip()]
                updates[name] = [_parse_scalar(s) for s in items]
            else:
                raw = m.group("val")
                updates[name] = (
                    _coerce(raw, current) if current is not None else _parse_scalar(raw)
                )
        return self.override(updates)

    # -- persistence (vqwae_train.py:1100-1102 contract) --
    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.values(), indent=2, sort_keys=True))

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        return cls().parse_json(Path(path).read_text())

    # ---- derived quantities ----
    def get_hop_size(self) -> int:
        # audio.py:128-133
        if self.hop_size is not None:
            return self.hop_size
        assert self.frame_shift_ms is not None
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    def get_win_length(self) -> int:
        # audio.py:136-141
        if self.win_length >= 0:
            return self.win_length
        assert self.win_length_ms > 0
        return int(self.win_length_ms / 1000 * self.sample_rate)

    @property
    def is_mulaw_quantize(self) -> bool:
        return self.input_type == "mulaw-quantize"

    @property
    def is_mulaw(self) -> bool:
        return self.input_type == "mulaw"

    @property
    def is_raw(self) -> bool:
        return self.input_type == "raw"

    @property
    def is_scalar_input(self) -> bool:
        # util.py:13-17: scalar input for raw / mulaw (MoL head), one-hot for
        # mulaw-quantize (softmax head)
        return self.is_raw or self.is_mulaw

    @property
    def upsample_scales(self) -> list[int]:
        return list(self.upsample_params.get("upsample_scales", []))

    @property
    def up_factor(self) -> int:
        """Samples per latent frame = hop_size * (100 // frame_rate)."""
        return self.get_hop_size() * (100 // self.frame_rate)


_PRESET_DIR = Path(__file__).parent / "presets"


def load_preset(name_or_path: str | Path, overrides: str = "") -> Config:
    """Load a JSON preset by bundled name (e.g. ``"vqwae"``) or by path, and
    apply an optional ``"k=v,..."`` override string on top."""
    p = Path(name_or_path)
    if not p.exists():
        p = _PRESET_DIR / f"{name_or_path}.json"
    cfg = Config().parse_json(p.read_text())
    return cfg.parse(overrides)


def available_presets() -> list[str]:
    return sorted(q.stem for q in _PRESET_DIR.glob("*.json"))
