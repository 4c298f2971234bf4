"""Shared helpers of the tests/test_torch_port_*.py files: tiny shapes, and
one set of weights loaded into both the JAX package and the PyTorch port."""
import numpy as np

TINY_SVQWAE = (
    "layers=4,stacks=2,residual_channels=16,gate_channels=32,"
    "skip_out_channels=16,encoder_hid=16,cin_channels=8,gin_channels=4,"
    "n_speakers=8,K=8,out_channels=32,quantize_channels=32,"
    "max_time_steps=128,hop_size=4,compute_dtype=float32"
)


def tiny_net_kwargs(**kw):
    """The tiny WaveNet of tests/test_decode_kernel.py."""
    d = dict(
        out_channels=256,
        layers=4,
        stacks=2,
        residual_channels=8,
        gate_channels=12,
        skip_out_channels=8,
        kernel_size=3,
        dropout=0.0,
        cin_channels=5,
        gin_channels=6,
        n_speakers=4,
        upsample_conditional_features=False,
        scalar_input=False,
        use_speaker_embedding=True,
    )
    d.update(kw)
    return d


def to_np(tree):
    """A JAX params tree as nested dicts/lists of numpy arrays."""
    import jax

    return jax.tree.map(np.asarray, tree)


def nets(seed=0, **kw):
    """(jax_net, jax_params, port_net) with the same weights."""
    import jax

    from wavenet_autoencoders_tpu.models.wavenet import WaveNet as JWaveNet
    from wavenet_autoencoders_tpu_torch.models.wavenet import WaveNet
    from wavenet_autoencoders_tpu_torch.utils.jax_random import PRNGKey
    from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params

    d = tiny_net_kwargs(**kw)
    jnet = JWaveNet(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()})
    params = jnet.init(jax.random.PRNGKey(seed))
    net = WaveNet(**d, key=PRNGKey(seed))
    load_jax_params(net, to_np(params))
    return jnet, params, net


def tiny_cfgs():
    """(jax Config, port Config) of a tiny svqwae."""
    from wavenet_autoencoders_tpu.config import load_preset as jload
    from wavenet_autoencoders_tpu_torch.config import load_preset

    up = {"upsample_scales": [2, 2]}
    return (
        jload("svqwae", TINY_SVQWAE).replace(upsample_params=up),
        load_preset("svqwae", TINY_SVQWAE).replace(upsample_params=up),
    )


def models(seed=0):
    """(jcfg, jmodel, params, state, cfg, model): a tiny svqwae in both
    packages with the same weights, the port's on the CPU."""
    import jax

    from wavenet_autoencoders_tpu.models.zoo import build_model as jbuild
    from wavenet_autoencoders_tpu_torch.models import build_model
    from wavenet_autoencoders_tpu_torch.utils.params import load_jax_params

    jcfg, cfg = tiny_cfgs()
    jmodel = jbuild(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, to_np(params))
    return jcfg, jmodel, params, state, cfg, model
