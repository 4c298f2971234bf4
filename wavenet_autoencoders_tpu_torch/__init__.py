"""wavenet_autoencoders_tpu_torch — the PyTorch/CUDA port of
``wavenet_autoencoders_tpu``.

It trains every model of the zoo and serves it (ABX export and AR
synthesis), with the same layout as the JAX package, so each module has its
counterpart under the same name:

- ``config``  — typed config, JSON presets, "k=v" overrides (own copy)
- ``dsp``     — mu-law, pre-emphasis, STFT, mel and MFCC features, filters,
                CMVN (numpy/scipy copies of the JAX package's)
- ``data``    — ZeroSpeech-2019 subsets, feature extraction, normalization;
                the train.txt manifest, dataset, sampler, collator, prefetch
- ``ops``     — weight-normed convs, the GLU cell, upsampler, mixture
                losses and samplers, masked losses
- ``models``  — WaveNet decoder, content and speaker encoders, bottlenecks
                (VQ, Gumbel, IN/AdaIN), the WAE zoo and the feature AEs
- ``kernels`` — the fused AR decode and the fused GLU-stack forward and
                backward (CUDA for Hopper, ``csrc/``), each with its plain
                PyTorch version
- ``train``   — train and eval steps (Adam, clipping, parameter EMA),
                schedules, checkpoints in the JAX package's npz format,
                metrics, the loop with its dev pass, sample dumps, decode
                and profiler hooks
- ``eval``    — ABX export, voice-conversion synthesis, submission checks
- ``utils``   — device selection and the JAX-parameter bridge
- ``cli``     — ``subset``, ``preprocess``, ``cmvn``, ``normalize``,
                ``train``, ``infer``, ``synthesize`` and ``validate``

The package imports torch, numpy and scipy only; it never imports JAX or
the JAX package. Entry points run on the CUDA device unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"

from wavenet_autoencoders_tpu_torch.config import Config, load_preset  # noqa: F401
