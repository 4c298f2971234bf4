"""Host-side waveform processing used by synthesis and the data feed
(numpy/scipy)."""
from wavenet_autoencoders_tpu_torch.dsp.filters import save_wav  # noqa: F401
from wavenet_autoencoders_tpu_torch.dsp.mulaw import (  # noqa: F401
    inv_mulaw,
    inv_mulaw_quantize,
    inv_preemphasis,
    mulaw,
    mulaw_quantize,
)
