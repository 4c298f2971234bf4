"""Host-side waveform post-processing used by synthesis (numpy/scipy)."""
from wavenet_autoencoders_tpu_torch.dsp.filters import save_wav  # noqa: F401
from wavenet_autoencoders_tpu_torch.dsp.mulaw import (  # noqa: F401
    inv_mulaw,
    inv_mulaw_quantize,
    inv_preemphasis,
)
