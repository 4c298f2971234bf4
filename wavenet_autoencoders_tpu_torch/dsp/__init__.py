"""Host-side DSP (numpy/scipy), copies of the JAX package's ``dsp``
functions so that the port's dumps equal the JAX package's bit for bit:

- mu-law companding + quantization, pre-emphasis and its inverse (``mulaw``)
- STFT, Slaney mel filterbank, DCT-II (``stft``)
- espnet-style log-mel + MFCC(13)+Δ+ΔΔ (``features``)
- FIR high-pass, silence trim, wav I/O (``filters``)
- streaming CMVN statistics (``cmvn``)

They run on the host, in preprocessing and around synthesis.
"""
from wavenet_autoencoders_tpu_torch.dsp.mulaw import (  # noqa: F401
    mulaw,
    inv_mulaw,
    mulaw_quantize,
    inv_mulaw_quantize,
    preemphasis,
    inv_preemphasis,
)
from wavenet_autoencoders_tpu_torch.dsp.stft import (  # noqa: F401
    stft,
    hann_window,
    mel_filterbank,
    dct_matrix,
)
from wavenet_autoencoders_tpu_torch.dsp.features import (  # noqa: F401
    logmelspectrogram,
    mfcc,
    delta,
)
from wavenet_autoencoders_tpu_torch.dsp.filters import (  # noqa: F401
    low_cut_filter,
    trim_silence_db,
    start_and_end_indices,
    trim_quantized,
    load_wav,
    save_wav,
    adjust_time_resolution,
)
from wavenet_autoencoders_tpu_torch.dsp.cmvn import CMVN  # noqa: F401
