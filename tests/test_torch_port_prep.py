"""The port's data preparation against the JAX package on the CPU: the DSP
functions, CMVN, ``make_subset``, ``preprocess``, normalization, the
submission validator, and the CLI chain ``subset -> preprocess -> cmvn ->
normalize`` on the wav tree of ``tests/test_e2e.py``.

The port keeps numpy/scipy copies of these functions, so every array must
equal the JAX package's bit for bit (``np.array_equal``, same dtype) and
every json must be equal; no tolerance anywhere.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import wavenet_autoencoders_tpu.dsp as jdsp  # noqa: E402
import wavenet_autoencoders_tpu_torch.dsp as pdsp  # noqa: E402
from wavenet_autoencoders_tpu.config import load_preset as jpreset  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import load_preset as ppreset  # noqa: E402

SR = 16000


def _signal(seed=0, dur=0.6, f0=220.0, sr=SR):
    """Sine plus noise, with quiet edges for the silence trim."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(dur * sr)) / sr
    y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(len(t))
    y[: len(y) // 6] *= 1e-4
    y[-len(y) // 8:] *= 1e-4
    return y.astype(np.float32)


def _write_wav(path, y, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module")
def plain_dir():
    """A scratch directory whose path holds no "test": ``process_utterance``
    trims silence only for such paths (pytest's own tmp paths hold it)."""
    with tempfile.TemporaryDirectory(prefix="wae_prep_") as d:
        yield Path(d)


CFG = "svqwae"
DSP_CASES = {
    "hann_window": lambda d, y, cfg: d.hann_window(400),
    "stft": lambda d, y, cfg: d.stft(y, n_fft=400, hop_length=160),
    "stft_reflect_short_window": lambda d, y, cfg: d.stft(y, n_fft=512, hop_length=128, win_length=400,
                                                          pad_mode="reflect"),
    "mel_filterbank": lambda d, y, cfg: d.mel_filterbank(SR, 400, n_mels=80, fmin=80.0, fmax=7600.0),
    "dct_matrix": lambda d, y, cfg: d.dct_matrix(13, 80),
    "logmelspectrogram": lambda d, y, cfg: d.logmelspectrogram(y, cfg),
    "mfcc": lambda d, y, cfg: d.mfcc(y, cfg),
    "delta": lambda d, y, cfg: np.stack([d.delta(d.mfcc(y, cfg)[:13], order=o) for o in (1, 2)]),
    "trim_silence_db": lambda d, y, cfg: np.concatenate(
        [d.trim_silence_db(y, top_db=60, frame_length=2048, hop_length=512)[0],
         np.asarray(d.trim_silence_db(y, top_db=60)[1], np.float32)]),
    "low_cut_filter": lambda d, y, cfg: d.low_cut_filter(y, SR, 70.0),
    "preemphasis": lambda d, y, cfg: d.preemphasis(y, 0.97),
    "start_and_end_indices": lambda d, y, cfg: np.asarray(
        d.start_and_end_indices(d.mulaw_quantize(y, 255))),
    "adjust_time_resolution": lambda d, y, cfg: np.concatenate(
        [a.ravel().astype(np.float64) for a in d.adjust_time_resolution(
            d.mulaw_quantize(y, 255), d.mfcc(y, cfg).T)]),
}


@pytest.mark.parametrize("name", sorted(DSP_CASES))
def test_dsp_function_equals_jax(name):
    y = _signal(1)
    fn = DSP_CASES[name]
    assert_same(fn(pdsp, y, ppreset(CFG)), fn(jdsp, y, jpreset(CFG)))


@pytest.mark.parametrize("sr", [16000, 22050, 8000])
def test_load_wav_equals_jax(tmp_path, sr):
    """16 kHz is read as is; the others are resampled to 16 kHz."""
    path = tmp_path / "x.wav"
    _write_wav(path, _signal(2, sr=sr), sr=sr)
    got, want = pdsp.load_wav(path, SR), jdsp.load_wav(path, SR)
    assert_same(got, want)
    assert len(got) == int(0.6 * SR)


def test_cmvn_statistics_equal_jax():
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal((n, 39)) * 3 + 1 for n in (17, 40, 5)]
    p, j = pdsp.CMVN(), jdsp.CMVN()
    for x in parts:
        p.partial_fit(x)
        j.partial_fit(x)
    assert p.n == j.n
    for attr in ("mean", "m2", "var", "scale"):
        assert_same(getattr(p, attr), getattr(j, attr))
    assert_same(p.transform(parts[0]), j.transform(parts[0]))
    assert_same(p.inverse_transform(parts[1]), j.inverse_transform(parts[1]))


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_cmvn_scaler_cross_loads(tmp_path, saver):
    x = np.random.default_rng(4).standard_normal((30, 39))
    src, dst = (pdsp.CMVN, jdsp.CMVN) if saver == "port" else (jdsp.CMVN, pdsp.CMVN)
    src().partial_fit(x).save(tmp_path / "s.npz")
    loaded, want = dst.load(tmp_path / "s.npz"), src.load(tmp_path / "s.npz")
    assert loaded.n == want.n
    assert_same(loaded.mean, want.mean)
    assert_same(loaded.m2, want.m2)
    assert_same(loaded.transform(x), want.transform(x))


def _zs_tree(root, n_unit=10, n_voice=4, n_test=2, dur=0.4):
    """A ZeroSpeech-2019 wav tree: <lan>/train/{unit,voice}/*.wav and
    <lan>/test/*.wav, speakers as filename prefixes."""
    for i in range(n_unit):
        _write_wav(root / "english/train/unit" / f"S0{i % 3:02d}_{1000 + i}.wav", _signal(10 + i, dur, 200 + 30 * i))
    for i in range(n_voice):
        _write_wav(root / "english/train/voice" / f"V00{i % 2 + 1}_{2000 + i}.wav", _signal(30 + i, dur, 150 + 20 * i))
    for i in range(n_test):
        _write_wav(root / "english/test" / f"S090_{3000 + i}.wav", _signal(50 + i, dur, 300 + 50 * i))
    return root


def _read_all(root: Path) -> dict:
    """{relative path: contents} of every file under ``root``; paths inside
    text and json files are made relative to ``root`` too."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".npy":
            out[rel] = np.load(p)
        elif p.suffix == ".npz":
            z = np.load(p)
            out[rel] = {k: z[k] for k in z.files}
        else:
            out[rel] = p.read_text().replace(str(root), "<root>")
    return out


def assert_trees_equal(a: Path, b: Path):
    fa, fb = _read_all(a), _read_all(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], dict):
            assert sorted(fa[k]) == sorted(fb[k]), k
            for key in fa[k]:
                assert_same(fa[k][key], fb[k][key])
        elif isinstance(fa[k], np.ndarray):
            assert_same(fa[k], fb[k])
        else:
            assert fa[k] == fb[k], k


def test_make_subset_equals_jax(plain_dir, capsys):
    from wavenet_autoencoders_tpu.data.subset import make_subset as jsubset
    from wavenet_autoencoders_tpu_torch.data.subset import make_subset

    wavs = _zs_tree(plain_dir / "subset_wavs", n_unit=150, n_voice=60, n_test=3, dur=0.05)
    outs = {}
    for name, fn in (("jax", jsubset), ("port", make_subset)):
        root = plain_dir / f"subset_{name}"
        sp2ind = fn("english", wavs, f"{root}/dump", f"{root}/scp")
        dirs = sorted(str(p.relative_to(root)) for p in (root / "dump").rglob("*"))
        outs[name] = (sp2ind, dirs, capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert_trees_equal(plain_dir / "subset_jax", plain_dir / "subset_port")
    scp = json.loads((plain_dir / "subset_port/scp/dev_src_dst.json").read_text())
    assert len(scp) == 2  # 1% of 210 train utterances
    assert sorted(p.name for p in (plain_dir / "subset_port/dump/english").iterdir()) == [
        "dev", "test", "train_no_dev"]


def _scp(path, wavs, dump):
    path.write_text(json.dumps([[str(w), f"{dump}/{w.stem}/"] for w in wavs]))
    return path


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("input_type", ["mulaw-quantize", "mulaw", "raw"])
def test_preprocess_equals_jax(plain_dir, input_type, workers):
    """wave.npy, mel.npy, mfcc.npy and train.txt, on 10 train utterances
    (trimmed) and 2 test ones (not trimmed); 2 workers use the pool."""
    from wavenet_autoencoders_tpu.data.preprocess import preprocess as jprep
    from wavenet_autoencoders_tpu_torch.data.preprocess import preprocess

    wavs = _zs_tree(plain_dir / f"prep_wavs_{input_type}_{workers}", n_unit=8, n_voice=2, n_test=2, dur=0.5)
    files = sorted(wavs.rglob("*.wav"))
    sp2ind = plain_dir / f"sp2ind_{input_type}_{workers}.json"
    sp2ind.write_text(json.dumps({"S000": 0, "S001": 1, "S002": 2, "V001": 3}))
    hp = f"input_type={input_type}"
    for name, fn, cfg in (("jax", jprep, jpreset(CFG, hp)), ("port", preprocess, ppreset(CFG, hp))):
        root = plain_dir / f"prep_{input_type}_{workers}_{name}"
        scp = _scp(plain_dir / f"scp_{input_type}_{workers}_{name}.json", files, root)
        meta = fn(cfg, str(scp), str(root), str(sp2ind), num_workers=1 if name == "jax" else workers)
        assert len(meta) == 12
    jroot, proot = (plain_dir / f"prep_{input_type}_{workers}_{n}" for n in ("jax", "port"))
    assert_trees_equal(jroot, proot)
    wave = np.load(next(proot.glob("S000_*")) / "wave.npy")
    assert wave.dtype == (np.int16 if input_type == "mulaw-quantize" else np.float32)
    rows = (proot / "train.txt").read_text().splitlines()
    # rows in scp order: test S090 x2, unit S000 x3, S001 x3, S002 x2, voice V001, V002 (not in the map)
    assert [int(r.split("|")[2]) for r in rows] == [-1, -1, 0, 0, 0, 1, 1, 1, 2, 2, 3, -1]


@pytest.mark.parametrize("inverse", [False, True])
def test_normalization_equals_jax(tmp_path, inverse):
    from wavenet_autoencoders_tpu.data.normalize import apply_normalization as japply
    from wavenet_autoencoders_tpu.data.normalize import compute_mean_var as jfit
    from wavenet_autoencoders_tpu_torch.data.normalize import apply_normalization, compute_mean_var

    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((n, 39)).astype(np.float32) * 2 + 0.5 for n in (20, 33, 7)]
    scps = {}
    for name in ("jax", "port"):
        dirs = [tmp_path / name / f"u{i}" for i in range(3)]
        for d, f in zip(dirs, feats):
            d.mkdir(parents=True)
            np.save(d / "mfcc.npy", f)
        scps[name] = tmp_path / f"{name}.json"
        scps[name].write_text(json.dumps([["x.wav", f"{d}/"] for d in dirs]))
    jfit([str(scps["jax"])], "mfcc", str(tmp_path / "jax.npz"))
    compute_mean_var([str(scps["port"])], "mfcc", str(tmp_path / "port.npz"))
    japply(str(scps["jax"]), "mfcc", str(tmp_path / "jax.npz"))
    apply_normalization(str(scps["port"]), "mfcc", str(tmp_path / "port.npz"))
    if inverse:
        japply(str(scps["jax"]), "mfcc", str(tmp_path / "jax.npz"), inverse=True)
        apply_normalization(str(scps["port"]), "mfcc", str(tmp_path / "port.npz"), inverse=True)
    assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    z, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    for k in ("n", "mean", "m2"):
        assert_same(z[k], zj[k])


def _submission(root):
    test_dir = root / "2019/english/test"
    test_dir.mkdir(parents=True)
    rng = np.random.default_rng(6)
    for i in range(3):
        np.savetxt(test_dir / f"S090_{i}.txt", rng.random((5, 4)), fmt="%.6f")
        wavfile.write(test_dir / f"V001_{i}.wav", 16000, (rng.random(1600) * 1000).astype(np.int16))
    return test_dir


def _columns(d):
    np.savetxt(d / "S090_bad.txt", np.random.default_rng(0).random((5, 7)), fmt="%.6f")


def _nan(d):
    np.savetxt(d / "S090_nan.txt", np.full((3, 4), np.nan))


def _empty_wav(d):
    (d / "V001_bad.wav").write_bytes(b"RIFF0000WAVE")


def _empty_txt(d):
    (d / "S090_empty.txt").write_text("")


# the failure trees of tests/test_eval_extras.py::test_validate_submission,
# plus an empty txt; "missing" asks for a language dir that is not there
FAILURES = {"columns": _columns, "non-finite": _nan, "wav": _empty_wav, "empty": _empty_txt, "missing": None}


@pytest.mark.parametrize("case", ["ok", *FAILURES])
def test_validate_submission_equals_jax(tmp_path, case):
    from wavenet_autoencoders_tpu.eval import validate as jv
    from wavenet_autoencoders_tpu_torch.eval import validate as pv

    test_dir = _submission(tmp_path)
    lan = "surprise" if case == "missing" else "english"
    if FAILURES.get(case):
        FAILURES[case](test_dir)
    if case == "ok":
        assert pv.validate_submission(tmp_path) == jv.validate_submission(tmp_path) == {
            "txt": 3, "wav": 3, "txt_cols": 4}
        return
    with pytest.raises(jv.ValidationError) as want:
        jv.validate_submission(tmp_path, lan=lan)
    with pytest.raises(pv.ValidationError, match=case) as got:
        pv.validate_submission(tmp_path, lan=lan)
    assert str(got.value) == str(want.value)
    assert issubclass(pv.ValidationError, ValueError)


def test_cli_subset_preprocess_cmvn_normalize_equal_jax(plain_dir, capsys):
    """The CLI chain of tests/test_e2e.py:24-52 and :60-95 through both
    packages on the same wav tree: every file written is the same."""
    from wavenet_autoencoders_tpu.cli.main import main as jcli
    from wavenet_autoencoders_tpu_torch.cli.main import main as pcli

    raw = plain_dir / "cli_raw"
    rng = np.random.default_rng(0)

    def make_wav(path, dur, f0):
        t = np.arange(int(dur * SR)) / SR
        _write_wav(path, 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(len(t)))

    for i in range(6):
        make_wav(raw / "english/train/unit" / f"S0{i % 3:02d}_{1000 + i}.wav", 0.5, 200 + 40 * i)
    for i in range(2):
        make_wav(raw / "english/train/voice" / f"V00{i + 1}_{2000 + i}.wav", 0.5, 150 + 30 * i)
    for i in range(2):
        make_wav(raw / "english/test" / f"S090_{3000 + i}.wav", 0.4, 300 + 50 * i)
    hp = ("layers=4,stacks=2,residual_channels=8,gate_channels=12,skip_out_channels=8,encoder_hid=16,"
          "cin_channels=8,gin_channels=4,n_speakers=8,K=8,batch_size=2,dev_batch_size=1,max_time_steps=1280,"
          "checkpoint_interval=4,compute_dtype=float32,num_slices=2")
    logs = {}
    for name, cli in (("jax", jcli), ("port", pcli)):
        root = plain_dir / f"cli_{name}"
        dump, scp = root / "dump/2019", root / "scp/2019"
        cli(["subset", "english", str(raw), str(dump) + "/", str(scp)])
        for split in ("train_no_dev", "test"):
            cli(["preprocess", "--preset", "svqwae", "--hparams", hp, str(scp / f"{split}_src_dst.json"),
                 str(dump / "english" / split), str(scp / "2019_speaker2ind_english.json"), "--num-workers", "1"])
        cli(["cmvn", "mfcc", str(root / "cmvn.npz"), str(scp / "train_no_dev_src_dst.json")])
        for split in ("train_no_dev", "test"):
            cli(["normalize", str(scp / f"{split}_src_dst.json"), "mfcc", str(root / "cmvn.npz")])
        logs[name] = capsys.readouterr().out.replace(str(root), "<root>")
    assert_trees_equal(plain_dir / "cli_jax", plain_dir / "cli_port")
    assert logs["port"] == logs["jax"]
    n = len(list((plain_dir / "cli_port").rglob("mfcc.norm.npy")))
    assert n == 10


def test_cli_validate(tmp_path, capsys):
    from wavenet_autoencoders_tpu_torch.cli.main import main as pcli

    _submission(tmp_path)
    pcli(["validate", str(tmp_path)])
    assert "submission OK: {'txt': 3, 'wav': 3, 'txt_cols': 4}" in capsys.readouterr().out
