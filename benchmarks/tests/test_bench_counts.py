"""The frozen counts at the main shapes give the bounds the port's records
quote (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s)."""
import json
from pathlib import Path

import pytest

from counts import flops

CONFIGS = json.load(open(flops.__file__.replace("counts/flops.py", "configs/svqwae.json")))
BENCH = Path(flops.__file__).resolve().parents[1]
VOCODER_RAW = json.loads((BENCH.parent / "wavenet_autoencoders_tpu_torch" / "presets" / "vocoder_raw.json").read_text())


def test_k2_k3_bounds_at_the_main_shape():
    f2, by2, f3, by3 = flops.glu_bound(40, 5120)
    assert f2 / 1e12 == pytest.approx(3.28, abs=0.005)
    assert flops.bound_ms(f2, by2) == pytest.approx(3.32, abs=0.005)
    assert flops.bound_ms(f3, by3) == pytest.approx(7.02, abs=0.005)
    assert f2 / flops.H100_BF16_FLOPS > by2 / flops.H100_BYTES_PER_S  # bound by operations


def test_k1_bound_at_the_decode_shape():
    w = flops.widths(CONFIGS)
    flop, ops_ms, bytes_ms = flops.k1_bound(256, 5120, has_g=True, **w)
    assert ops_ms == pytest.approx(21.57, abs=0.005)
    assert ops_ms > bytes_ms


def test_step_counts_at_the_configs_shapes():
    # the stack's forward is K2's own count; the step is 3 forwards
    assert flops.forward_flop(CONFIGS, 40, 5120) == pytest.approx(
        flops.glu_bound(40, 5120)[0] + 2.0 * 40 * 5120 * (256 * 256 * 2)
        + flops.encoder_flop(CONFIGS, 40, 32) + flops.upsampler_flop(CONFIGS, 40, 8) + 2.0 * 40 * 8 * 256 * 64)
    assert flops.train_step_flop(CONFIGS, 40, 5120) / 1e12 == pytest.approx(10.05, abs=0.02)
    assert flops.decode_flop(CONFIGS, 1) == 2 * flops.k1_mac_row_step(256, 368, 256, 256, 20, 64)


def test_share_reads_nothing_where_nothing_was_measured():
    assert flops.share(1.0, 0.0) is None
    assert flops.share(1.0, 4.0) == 25.0


# the counts of the benchmark's configurations before the count learned the
# vocoder, to the last bit: train_mfu reads the same work
PINNED = {"svqwae": (40, 5120, 3348259307520, 10044777922560), "inae": (10, 5120, 834760540160, 2504281620480)}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_wae_counts_are_pinned(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    B, T, fwd, step = PINNED[name]
    assert (cfg["batch_size"], cfg["max_time_steps"]) == (B, T)
    assert flops.forward_flop(cfg, B, T) == fwd and flops.train_step_flop(cfg, B, T) == step


def test_the_vocoder_counts_its_upsampler_stack_and_post_net_and_no_encoder():
    cfg = VOCODER_RAW
    B, T = cfg["batch_size"], cfg["max_time_steps"]
    assert (cfg["name"], B, T, cfg["hop_size"], cfg["cin_pad"]) == ("wavenet_vocoder", 8, 10240, 256, 2)
    # the context conv: 40 + 2·2 mel frames in, 40 out, 80 × 80 × 5 taps; the
    # four ×4 smoothing convs: 9 taps over every one of 80 channels
    up = 2.0 * B * (40 * 80 * 80 * 5 + (160 + 640 + 2560 + 10240) * 80 * 9)
    stack = flops.glu_bound(B, T, C=128, G=256, S=128, cin=80, L=24, has_g=False)[0]
    post = 2.0 * B * T * (128 * 128 + 128 * 30)
    assert flops.upsampler_flop(cfg, B, 44) == up
    assert flops.forward_flop(cfg, B, T) == up + stack + post
    assert flops.train_step_flop(cfg, B, T) / 1e12 == pytest.approx(1.80, abs=0.005)
    f2, by2, f3, by3 = flops.glu_bound(B, T, C=128, G=256, S=128, cin=80, L=24, has_g=False)
    assert flops.bound_ms(f2, by2) == pytest.approx(0.60, abs=0.005)
    assert flops.bound_ms(f3, by3) == pytest.approx(1.27, abs=0.005)


def test_a_model_with_no_count_is_refused():
    with pytest.raises(ValueError):
        flops.forward_flop({**CONFIGS, "name": "ae4"}, 40, 5120)  # a feature AE: no WaveNet
