"""WaveNet decoder, encoders, bottlenecks and the model zoo."""
from wavenet_autoencoders_tpu_torch.models.zoo import build_model, build_wavenet  # noqa: F401
