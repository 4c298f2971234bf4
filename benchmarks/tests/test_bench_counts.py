"""The frozen counts at the main shapes give the bounds the port's records
quote (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s)."""
import json

import pytest

from counts import flops

CONFIGS = json.load(open(flops.__file__.replace("counts/flops.py", "configs/svqwae.json")))


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
