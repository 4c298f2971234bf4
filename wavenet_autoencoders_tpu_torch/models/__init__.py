"""WaveNet decoder, content encoder, VQ bottlenecks and the VQWAE model."""
from wavenet_autoencoders_tpu_torch.models.zoo import build_model, build_wavenet  # noqa: F401
