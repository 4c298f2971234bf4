"""Synthesis and the training hooks' samples against the JAX package on the
CPU, end to end, with their own draws: the port's ``batch_wavegen``,
``run_synthesis_list`` (through the CLI's ``synthesize``), ``save_states``
and ``eval_model`` draw from the JAX package's keys (``PRNGKey(0)``,
``PRNGKey(cfg.seed)`` split per chunk, ``PRNGKey(step)``,
``PRNGKey(cfg.seed + step)``) through the JAX decode's splits, and the
JAX package runs its plain decode (``eval/synthesize.py``: no decode
kernel on a CPU). Same weights (JAX ``init``) in both packages, random:
no output bias is pinned.

Held: mu-law output (tiny svqwae) writes the JAX package's codes, so the
same wav samples, exactly. Mixture output (tiny ``vocoder_raw``, 256-bin
MoL, with speaker ids; a mu-law-input MoL net for the sample dump): the
same draws, but each sample passes through ``log`` and ``exp``, where
XLA's f32 functions differ from torch's in the last bit
(``tests/test_torch_port_draws.py``), and is fed back as the next input,
so the 16-bit wavs are held within one step of their last bit (every
sample was equal when this file was written).
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_port_util import models, tiny_cfgs  # noqa: E402
from test_torch_port_zoo import pair  # noqa: E402


def _checkpoint(tmp_path, jcfg, params, state):
    from wavenet_autoencoders_tpu.train.checkpoint import save_pytree

    ckpt = tmp_path / "checkpoint_step000000010.npz"
    save_pytree({"params": params, "model_state": state, "step": np.int64(10)}, ckpt)
    cfg_path = tmp_path / "config.json"
    jcfg.save(cfg_path)
    return ckpt, cfg_path


def _dump(tmp_path, frames, dim):
    """Test utterances of the given frame counts, one per line of a
    synthesis list (two target speakers)."""
    dump = tmp_path / "dump" / "english" / "test"
    lines = []
    for i, n in enumerate(frames):
        d = dump / f"V00{i % 2 + 1}_{100 + i}"
        d.mkdir(parents=True)
        np.save(d / "mfcc.norm.npy", np.random.default_rng(10 + i).standard_normal((n, dim)).astype(np.float32))
        lines.append(f"{d.name} V00{2 - i % 2}\n")
    syn = tmp_path / "synthesis.txt"
    syn.write_text("".join(lines))
    sp2ind = tmp_path / "sp2ind.json"
    sp2ind.write_text(json.dumps({"V001": 0, "V002": 1}))
    return dump, syn, sp2ind


def _wavs(d):
    return {p.name: wavfile.read(p)[1] for p in sorted(d.rglob("*.wav"))}


def _assert_wavs(got, want, exact):
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].shape == want[k].shape, k
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert np.abs(got[k].astype(np.int64) - want[k]).max() <= 1, k
        assert np.abs(want[k]).max() > 0, k


FAMILIES = {
    # name: (frames per utterance, feature dim, held exactly)
    "svqwae": ((18, 18, 26, 18), 39, True),
    "vocoder_raw": ((12, 12, 16), 8, False),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cli_synthesize_writes_the_jax_cli_wavs(tmp_path, family):
    """``synthesize --batch 2`` of both CLIs on the same checkpoint and test
    set: groups of equal length in chunks of 2, one split of
    ``PRNGKey(cfg.seed)`` a chunk."""
    from wavenet_autoencoders_tpu.cli.main import main as jmain
    from wavenet_autoencoders_tpu_torch.cli.main import main

    frames, dim, exact = FAMILIES[family]
    if family == "svqwae":
        jcfg, _, params, state, _, _ = models(seed=5)
    else:
        # speaker ids conditioned (gin 4): the JAX plain decode cannot drop
        # them for gin = -1 (ROADMAP.md section 3)
        (jcfg, _, js), _ = pair(family, seed=5, gin_channels=4)
        params, state = js.params, js.model_state
    ckpt, cfg_path = _checkpoint(tmp_path, jcfg, params, state)
    dump, syn, sp2ind = _dump(tmp_path, frames, dim)
    common = ["--preset", str(cfg_path), str(ckpt), str(dump)]
    tail = [str(syn), str(sp2ind), "english", "--batch", "2"]
    jmain(["synthesize", *common, str(tmp_path / "jax"), *tail])
    main(["synthesize", "--device", "cpu", *common, str(tmp_path / "port"), *tail])
    want, got = _wavs(tmp_path / "jax"), _wavs(tmp_path / "port")
    assert len(want) == len(frames)
    _assert_wavs(got, want, exact)


def test_batch_wavegen_draws_from_jax_key_zero():
    """The default key, ``PRNGKey(0)``, and a key passed in: the JAX
    package's samples, exactly (mu-law)."""
    from wavenet_autoencoders_tpu.eval.synthesize import batch_wavegen as jwavegen
    from wavenet_autoencoders_tpu_torch.eval.synthesize import batch_wavegen
    from wavenet_autoencoders_tpu_torch.utils import jax_random as jr

    jcfg, jmodel, params, state, cfg, model = models(seed=2)
    c = np.random.default_rng(2).standard_normal((2, 18, 39)).astype(np.float32)
    g = np.array([1, 4], np.int32)
    want = jwavegen(jcfg, jmodel, params, state, c, g)
    got = batch_wavegen(cfg, model, c, g, device="cpu")
    np.testing.assert_array_equal(got, want)
    want = jwavegen(jcfg, jmodel, params, state, c, g, key=jax.random.PRNGKey(6))
    got = batch_wavegen(cfg, model, c, g, key=jr.PRNGKey(6), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 4


def test_save_states_samples_the_mixture_from_jax_key_step(tmp_path):
    """Scalar output on mu-law input (the JAX dump zeroes a writable array
    there): the prediction is ``sample(PRNGKey(step), y_hat[None])`` of the
    picked item, as in the JAX package."""
    from wavenet_autoencoders_tpu.train.eval_hooks import save_states as jsave
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import save_states

    jcfg, cfg = (c.replace(input_type="mulaw", output_distribution="Logistic", out_channels=30)
                 for c in tiny_cfgs())
    rng = np.random.default_rng(4)
    b = {"x": rng.uniform(-1, 1, (2, 48)).astype(np.float32), "y": rng.uniform(-0.5, 0.5, (2, 48, 1)).astype(np.float32),
         "lengths": np.array([48, 40], np.int32)}
    y_hat = rng.standard_normal((2, 48, 30)).astype(np.float32)
    for step in (7, 12):
        jsave(jcfg, step, y_hat, b, tmp_path / "jax")
        save_states(cfg, step, torch.from_numpy(y_hat), {k: torch.from_numpy(v) for k, v in b.items()},
                    tmp_path / "port")
    _assert_wavs(_wavs(tmp_path / "port"), _wavs(tmp_path / "jax"), exact=False)


def test_eval_model_decodes_from_jax_key_seed_plus_step(tmp_path):
    """``eval_model``'s decode of the picked item draws from
    ``PRNGKey(cfg.seed + step)``: the JAX package's wav, exactly."""
    from wavenet_autoencoders_tpu.train.eval_hooks import eval_model as jeval
    from wavenet_autoencoders_tpu_torch.train.eval_hooks import eval_model

    jcfg, jmodel, params, state, cfg, model = models(seed=3)
    rng = np.random.default_rng(5)
    b = {"x": rng.integers(0, 32, (2, 32)).astype(np.int32), "y": rng.integers(0, 32, (2, 32, 1)).astype(np.int32),
         "c": rng.standard_normal((2, 32, 39)).astype(np.float32), "g": np.array([1, 5], np.int32),
         "lengths": np.array([32, 27], np.int32)}
    for step in (8, 9):
        jeval(jcfg, jmodel, params, state, step, b, tmp_path / "jax")
        eval_model(cfg, model, step, {k: torch.from_numpy(v) for k, v in b.items()}, tmp_path / "port")
    got, want = _wavs(tmp_path / "port"), _wavs(tmp_path / "jax")
    _assert_wavs(got, want, exact=True)
    assert not np.array_equal(got["step000000008_predicted.wav"], got["step000000009_predicted.wav"])
