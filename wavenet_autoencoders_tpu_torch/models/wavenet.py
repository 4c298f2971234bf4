"""WaveNet AR decoder — teacher-forced batch forward and AR decode.

Counterpart of ``wavenet_autoencoders_tpu/models/wavenet.py``. The JAX
package keeps the architecture on a frozen dataclass and the weights in a
params tree; here both live on one ``nn.Module`` whose parameter names are
the JAX tree paths (``first``, ``layers.3.conv.g``, ``post1``, ``post2``,
``embed.table``, ``upsample.conv_in.w``, ...).

- ``apply``: the teacher-forced forward over (B, T, C), convs through
  ``F.conv1d``, in a compute ``dtype`` when given; with ``fused_stack`` (and
  kernel size 3, no dropout) the residual-GLU stack runs as one
  ``FusedGLUStack`` (``kernels/glu_stack.py``: K2 forward, K3 backward).
  (The name shadows ``nn.Module.apply(fn)``, keeping the JAX package's
  vocabulary; ``forward`` is the same method.)
- ``decode``: the plain AR loop (the JAX ``lax.scan`` becomes a Python loop
  over ``step``), for any kernel size.
- ``decode_kernel``: the fused decode of ``kernels/decode.py`` — the CUDA
  kernel on a CUDA device, its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_autoencoders_tpu_torch.ops.conv import (
    Conv1d,
    WNConv1d,
    conv1d_apply,
    conv1d_weight,
    receptive_field_size,
)
from wavenet_autoencoders_tpu_torch.ops.mixture import (
    sample_from_discretized_mix_logistic,
    sample_from_mix_gaussian,
)
from wavenet_autoencoders_tpu_torch.ops.modules import (
    Embedding,
    ResidualGLU,
    glu_buffer_len,
    residual_glu_apply,
    residual_glu_step,
)
from wavenet_autoencoders_tpu_torch.ops.upsample import (
    ConvInUpsample,
    UpsampleNetwork,
    conv_in_upsample_apply,
    upsample_network_apply,
)


class WaveNet(nn.Module):
    """Architecture arguments as in the JAX ``WaveNet`` dataclass; weights
    are drawn from ``generator`` with the JAX package's init rules."""

    def __init__(
        self,
        out_channels: int = 256,
        layers: int = 20,
        stacks: int = 2,
        residual_channels: int = 512,
        gate_channels: int = 512,
        skip_out_channels: int = 512,
        kernel_size: int = 3,
        dropout: float = 0.05,
        cin_channels: int = -1,
        gin_channels: int = -1,
        n_speakers: int | None = None,
        upsample_conditional_features: bool = False,
        upsample_net: str = "ConvInUpsampleNetwork",
        upsample_scales: tuple = (4, 4, 4, 4),
        freq_axis_kernel_size: int = 1,
        cin_pad: int = 0,
        scalar_input: bool = False,
        use_speaker_embedding: bool = False,
        output_distribution: str = "Logistic",
        fused_stack: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.n_layers = layers
        self.stacks = stacks
        self.residual_channels = residual_channels
        self.gate_channels = gate_channels
        self.skip_out_channels = skip_out_channels
        self.kernel_size = kernel_size
        self.dropout = dropout
        self.cin_channels = cin_channels
        self.gin_channels = gin_channels
        self.n_speakers = n_speakers
        self.upsample_conditional_features = upsample_conditional_features
        self.upsample_net = upsample_net
        self.upsample_scales = tuple(upsample_scales)
        self.freq_axis_kernel_size = freq_axis_kernel_size
        self.cin_pad = cin_pad
        self.scalar_input = scalar_input
        self.use_speaker_embedding = use_speaker_embedding
        self.output_distribution = output_distribution
        self.fused_stack = fused_stack

        gen = generator
        self.first = WNConv1d(self.in_channels, residual_channels, 1, generator=gen)
        self.layers = nn.ModuleList(
            ResidualGLU(
                residual_channels,
                gate_channels,
                kernel_size,
                skip_out_channels=skip_out_channels,
                cin_channels=cin_channels,
                gin_channels=gin_channels,
                generator=gen,
            )
            for _ in range(layers)
        )
        self.post1 = WNConv1d(skip_out_channels, skip_out_channels, 1, generator=gen)
        self.post2 = WNConv1d(skip_out_channels, out_channels, 1, generator=gen)
        self.embed = None
        if self.has_speaker_embedding():
            assert n_speakers is not None
            self.embed = Embedding(n_speakers, gin_channels, std=0.1, generator=gen)
        self.upsample = None
        if upsample_conditional_features:
            if upsample_net == "ConvInUpsampleNetwork":
                self.upsample = ConvInUpsample(
                    cin_channels, cin_pad, upsample_scales, freq_axis_kernel_size, generator=gen
                )
            else:
                self.upsample = UpsampleNetwork(upsample_scales, freq_axis_kernel_size)

    # ---- derived ----
    @property
    def layers_per_stack(self) -> int:
        assert self.n_layers % self.stacks == 0
        return self.n_layers // self.stacks

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % self.layers_per_stack)

    @property
    def receptive_field(self) -> int:
        return receptive_field_size(self.n_layers, self.stacks, self.kernel_size)

    @property
    def in_channels(self) -> int:
        return 1 if self.scalar_input else self.out_channels

    def has_speaker_embedding(self) -> bool:
        return self.gin_channels > 0 and self.use_speaker_embedding

    def local_conditioning_enabled(self) -> bool:
        return self.cin_channels > 0

    # ------------------------------------------------------------------
    def _global_features(self, g):
        """Speaker ids (B,) -> (B, gin) via the embedding, or continuous
        global features (B, gin) passed through."""
        if g is None:
            return None
        if self.has_speaker_embedding():
            return self.embed.table[g.reshape(-1).long()]
        if g.ndim == 3:  # (B, C, 1) channel-first edge case
            g = g[:, :, 0]
        return g

    def upsample_conditioning(self, c, dtype=None):
        """(B, T', cin) frame-rate conditioning -> (B, T, cin) sample-rate."""
        if c is None or not self.upsample_conditional_features:
            return c
        if self.upsample_net == "ConvInUpsampleNetwork":
            return conv_in_upsample_apply(
                self.upsample, c, self.upsample_scales, self.freq_axis_kernel_size, dtype=dtype
            )
        return upsample_network_apply(
            self.upsample, c, self.upsample_scales, self.freq_axis_kernel_size,
            cin_pad=self.cin_pad, dtype=dtype,
        )

    def _align_conditioning(self, c, T, upsampled=False, dtype=None):
        """Bring conditioning to sample rate (length T): the learned
        upsampler, or a frame repeat when the model has none."""
        if c is None:
            return None
        if not upsampled:
            c = self.upsample_conditioning(c, dtype=dtype)
        if not self.upsample_conditional_features and c.shape[1] != T:
            assert T % c.shape[1] == 0, (
                f"T={T} is not a multiple of conditioning frames {c.shape[1]} "
                "(no-upsampler repeat path)"
            )
            c = c.repeat_interleave(T // c.shape[1], dim=1)
        assert c.shape[1] == T, f"conditioning {tuple(c.shape)} vs T={T}"
        return c

    def apply(self, x, c=None, g=None, *, softmax: bool = False, upsampled: bool = False,
              train: bool = False, dtype=None):
        """Teacher-forced forward.

        x: (B, T, in_channels) one-hot or (B, T, 1) scalar input, or (B, T)
           integer codes (the first 1x1 then is a row gather of its weight).
        c: (B, T', cin) conditioning at frame rate (upsampled here unless
           ``upsampled``). g: (B,) int speaker ids or (B, gin) features.
        train: training mode (dropout, which is not ported, raises).
        dtype: compute dtype of the convs (None = f32 throughout).
        Returns logits/params (B, T, out_channels).
        """
        T = x.shape[1]
        g_feat = self._global_features(g)
        c = self._align_conditioning(c, T, upsampled=upsampled, dtype=dtype)
        if x.ndim == 2 and not x.is_floating_point():
            h = conv1d_weight(self.first, dtype)[0][x.long()] + self.first.b
        else:
            h = conv1d_apply(self.first, x, dtype=dtype)
        if self.fused_stack and self.kernel_size == 3 and self.dropout == 0.0:
            skips = self._fused_stack(h, c, g_feat, dtype)
        else:
            skips = 0.0
            for i, lp in enumerate(self.layers):
                h, s = residual_glu_apply(
                    lp, h, c, g_feat, dilation=self.dilation(i),
                    dropout=self.dropout if train else 0.0, dtype=dtype,
                )
                skips = skips + s
        skips = skips * math.sqrt(1.0 / self.n_layers)
        out = conv1d_apply(self.post1, F.relu(skips), dtype=dtype)
        out = conv1d_apply(self.post2, F.relu(out), dtype=dtype)
        if softmax:
            out = torch.softmax(out, dim=-1)
        return out

    forward = apply

    def _fused_stack(self, h, c, g_feat, dtype):
        """The whole residual-GLU stack as one ``FusedGLUStack``: folded
        weights stacked per layer, the per-layer global addends (B, L, G)
        computed here. Returns the unscaled skip sum in f32. Weight norm,
        ``gproj`` and the embedding stay in autograd, outside the kernel."""
        from wavenet_autoencoders_tpu_torch.kernels.glu_stack import FusedGLUStack

        if dtype is not None:
            h = h.to(dtype)
            c = None if c is None else c.to(dtype)
        lays = self.layers
        wc = None if c is None else torch.stack([conv1d_weight(lp.cproj, dtype)[0] for lp in lays])
        g_adds = None
        if g_feat is not None and lays[0].gproj is not None:
            g_adds = torch.stack(
                [g_feat @ conv1d_weight(lp.gproj, dtype)[0].float() for lp in lays], dim=1
            )
        return FusedGLUStack.apply(
            h, c, g_adds,
            torch.stack([conv1d_weight(lp.conv, dtype) for lp in lays]),
            torch.stack([lp.conv.b for lp in lays]),
            wc,
            torch.stack([conv1d_weight(lp.out, dtype)[0] for lp in lays]),
            torch.stack([lp.out.b for lp in lays]),
            torch.stack([conv1d_weight(lp.skip, dtype)[0] for lp in lays]),
            torch.stack([lp.skip.b for lp in lays]),
            tuple(self.dilation(i) for i in range(self.n_layers)),
        ).float()

    # ------------------------------------------------------------------
    # AR decoding
    # ------------------------------------------------------------------
    def init_buffers(self, batch: int, dtype=torch.float32, device=None) -> list:
        """Zeroed ring buffers, one per layer: (B, (k-1)·d_i, residual)."""
        return [
            torch.zeros(
                batch,
                glu_buffer_len(self.kernel_size, self.dilation(i)),
                self.residual_channels,
                dtype=dtype,
                device=device,
            )
            for i in range(self.n_layers)
        ]

    def step(self, x_t, buffers: list, t: int, ct, g_feat):
        """One network step: x_t (B, in_channels) -> logits (B, out). The
        buffers are updated in place and returned."""
        h = x_t @ conv1d_weight(self.first)[0] + self.first.b
        skips = 0.0
        for i, lp in enumerate(self.layers):
            h, s, buffers[i] = residual_glu_step(
                lp, h, buffers[i], t, ct, g_feat,
                dilation=self.dilation(i), kernel_size=self.kernel_size,
            )
            skips = skips + s
        skips = skips * math.sqrt(1.0 / self.n_layers)
        out = F.relu(skips) @ conv1d_weight(self.post1)[0] + self.post1.b
        out = F.relu(out) @ conv1d_weight(self.post2)[0] + self.post2.b
        return out, buffers

    def sample_output(self, logits, generator=None, *, softmax=True, quantize=True,
                      log_scale_min=-50.0):
        """Map one step's logits (B, out) to the next input and the recorded
        output."""
        if self.scalar_input:
            y = logits[:, None, :]
            if self.output_distribution == "Logistic":
                x = sample_from_discretized_mix_logistic(y, generator, log_scale_min=log_scale_min)
            elif self.output_distribution == "Normal":
                x = sample_from_mix_gaussian(y, generator, log_scale_min=log_scale_min)
            else:
                raise ValueError(self.output_distribution)
            return x.reshape(-1, 1)
        probs = torch.softmax(logits, dim=-1) if softmax else logits
        if quantize:
            # categorical draw by Gumbel-argmax over log-probabilities
            u = torch.rand(probs.shape, generator=generator, device=probs.device)
            u = u.clamp(1e-12, 1.0 - 1e-7)
            idx = (torch.log(probs.clamp_min(1e-12)) - torch.log(-torch.log(u))).argmax(-1)
            return F.one_hot(idx, self.out_channels).to(logits.dtype)
        return probs

    @torch.no_grad()
    def decode(
        self,
        T: int,
        c=None,
        g=None,
        initial_input=None,
        test_inputs=None,
        *,
        generator: torch.Generator | None = None,
        softmax: bool = True,
        quantize: bool = True,
        log_scale_min: float = -50.0,
        upsampled: bool = False,
    ) -> torch.Tensor:
        """Plain AR generation, one ``step`` per sample.

        c: (B, T', cin) frame conditioning (upsampled here unless
        ``upsampled``); g: (B,) ids or (B, gin); test_inputs (B, T, C) runs
        the buffered path teacher-forced. Returns (B, T, out_channels)
        one-hot/probs, or (B, T, 1) scalar samples.
        """
        dev = self.first.v.device
        if c is not None:
            B = c.shape[0]
        elif test_inputs is not None:
            B = test_inputs.shape[0]
        elif initial_input is not None:
            B = initial_input.shape[0]
        else:
            B = 1
        g_feat = self._global_features(g)
        c = self._align_conditioning(c, T, upsampled=upsampled)
        if initial_input is None:
            if self.scalar_input:
                x = torch.zeros(B, 1, device=dev)
            else:  # mu-law silence code 127 (all zeros when out_channels <= 127)
                x = torch.zeros(B, self.out_channels, device=dev)
                if self.out_channels > 127:
                    x[:, 127] = 1.0
        else:
            x = initial_input.reshape(B, -1).float()
        buffers = self.init_buffers(B, device=dev)
        ys = []
        for t in range(T):
            if test_inputs is not None:
                x = test_inputs[:, t]
            ct = None if c is None else c[:, t]
            logits, buffers = self.step(x, buffers, t, ct, g_feat)
            out = self.sample_output(
                logits, generator, softmax=softmax, quantize=quantize,
                log_scale_min=log_scale_min,
            )
            ys.append(out)
            x = out.to(x.dtype)
        return torch.stack(ys, dim=1)

    @torch.no_grad()
    def decode_kernel(
        self,
        T: int,
        c=None,
        g=None,
        *,
        seed: int = 0,
        upsampled: bool = False,
        dtype_str: str = "bfloat16",
    ):
        """Fused AR generation (``kernels/decode.py``): the CUDA kernel for
        CUDA tensors, its plain version for CPU tensors. ``seed`` keys the
        sampling noise.

        Returns (codes (B, T) int32, logits (B, T, O)) for mu-law-quantize,
        or (samples (B, T) float in [-1, 1], mixture params) for scalar
        input."""
        from wavenet_autoencoders_tpu_torch.kernels.decode import (
            pack_decode_weights,
            precompute_g_add,
            wavenet_decode,
        )

        c = self._align_conditioning(c, T, upsampled=upsampled)
        packed = pack_decode_weights(self)
        g_add = precompute_g_add(self, g)
        return wavenet_decode(
            self, packed, T, seed, c_up=c, g_add=g_add, dtype_str=dtype_str
        )


def fold_weight_norm(model: nn.Module) -> nn.Module:
    """Replace every weight-normed conv by a plain conv holding the folded
    weight ``w`` (and its bias) for inference, in place. The function the
    module computes is unchanged."""
    for name, child in list(model.named_children()):
        if isinstance(child, WNConv1d):
            k, cin, cout = child.v.shape
            plain = Conv1d(cin, cout, k, bias=child.b is not None)
            with torch.no_grad():
                plain.w = nn.Parameter(conv1d_weight(child).detach().clone())
                if child.b is not None:
                    plain.b = nn.Parameter(child.b.detach().clone())
            setattr(model, name, plain.to(child.v.device))
        else:
            fold_weight_norm(child)
    return model
