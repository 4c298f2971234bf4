"""The port's native data loader (``data/native.py``, its own copy of
``native/dataload.cpp``), mirroring tests/test_native_loader.py: npy
headers, hop-aligned crops with and without ``cin_pad``, determinism per
seed; then bit for bit against the JAX package's loader (built there with
``-march=native``, here without) on the same dump and seed, a rank's
``host_slice`` against the rows of the full load, the first batches of the
port's ``data_iterator`` against the JAX package's, and the build: a
missing compiler raises, concurrent first builds load one whole library.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from wavenet_autoencoders_tpu_torch.data import native  # noqa: E402


@pytest.fixture()
def dump(tmp_path):
    rng = np.random.default_rng(0)
    hop, N, D = 4, 64, 7
    items = []
    for i in range(3):
        wave = rng.integers(0, 256, N * hop).astype(np.int16)
        feat = rng.standard_normal((N, D)).astype(np.float32)
        wp = tmp_path / f"u{i}_wave.npy"
        fp = tmp_path / f"u{i}_mfcc.npy"
        np.save(wp, wave)
        np.save(fp, feat)
        items.append((str(wp), str(fp), wave, feat))
    return {"items": items, "hop": hop, "N": N, "D": D}


@pytest.fixture()
def jax_native(tmp_path, monkeypatch):
    """The JAX package's loader binding on a library built from its own
    source with its own flags (``native/build.sh``), but into ``tmp_path``:
    the JAX package's first use builds in place, so a worker racing another
    on that first build could load a half-written file."""
    import shutil
    import subprocess

    from wavenet_autoencoders_tpu.data import native as jnative

    lib = tmp_path / "jax_build" / "libwaedata.so"
    lib.parent.mkdir()
    flags = [f for f in (jnative._NATIVE_DIR / "build.sh").read_text().split("g++", 1)[1].split(" -o ")[0].split()
             if f != "\\"]
    assert "-march=native" in flags and "-march=native" not in native.CXX_FLAGS
    subprocess.run([shutil.which("g++"), *flags, "-o", str(lib), str(jnative._NATIVE_DIR / "dataload.cpp")],
                   check=True, capture_output=True, timeout=120)
    monkeypatch.setattr(jnative, "_LIB_PATH", lib)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def _paths(dump):
    return [it[0] for it in dump["items"]], [it[1] for it in dump["items"]]


def test_npy_shape(dump):
    wp, fp, wave, feat = dump["items"][0]
    assert native.npy_shape(wp) == (len(wave), 1)
    assert native.npy_shape(fp) == feat.shape


@pytest.mark.parametrize("cin_pad", [0, 2])
def test_batch_crop_alignment(dump, cin_pad):
    """Each crop is wave[s*hop : s*hop + max_steps] with feat[s - cin_pad :
    s + 8 + cin_pad] for some s in [cin_pad, N - 8 - cin_pad]."""
    hop, D = dump["hop"], dump["D"]
    max_steps = 8 * hop
    x, c = native.load_batch_native(*_paths(dump), max_steps, hop, cin_pad, D, seed=123)
    assert x.shape == (3, max_steps) and c.shape == (3, 8 + 2 * cin_pad, D)
    for b, (_wp, _fp, wave, feat) in enumerate(dump["items"]):
        starts = [s for s in range(cin_pad, dump["N"] - 8 - cin_pad + 1)
                  if np.array_equal(x[b], wave[s * hop : s * hop + max_steps])]
        assert starts, f"crop {b} is not an aligned window"
        np.testing.assert_array_equal(c[b], feat[starts[0] - cin_pad : starts[0] + 8 + cin_pad])


def test_deterministic_per_seed(dump):
    hop, D = dump["hop"], dump["D"]
    x1, c1 = native.load_batch_native(*_paths(dump), 16, hop, 0, D, seed=42)
    x2, c2 = native.load_batch_native(*_paths(dump), 16, hop, 0, D, seed=42)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(c1, c2)
    x3, _ = native.load_batch_native(*_paths(dump), 16, hop, 0, D, seed=43)
    assert not np.array_equal(x1, x3)


def test_refused_input_raises_loader_refused(dump, tmp_path):
    """A Fortran-order npy is refused by design (the caller collates it in
    Python), as is an utterance too short for the crop."""
    hop, D = dump["hop"], dump["D"]
    waves, feats = _paths(dump)
    fortran = tmp_path / "f_mfcc.npy"
    np.save(fortran, np.asfortranarray(dump["items"][0][3]))
    with pytest.raises(native.LoaderRefused):
        native.load_batch_native(waves[:1], [str(fortran)], 16, hop, 0, D, seed=1)
    with pytest.raises(native.LoaderRefused):
        native.load_batch_native(waves, feats, dump["N"] * hop, hop, 1, D, seed=1)


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
def test_batches_equal_the_jax_package_loader_bit_for_bit(dump, seed, jax_native):
    hop, D = dump["hop"], dump["D"]
    for cin_pad in (0, 2):
        want = jax_native.load_batch_native(*_paths(dump), 8 * hop, hop, cin_pad, D, seed)
        got = native.load_batch_native(*_paths(dump), 8 * hop, hop, cin_pad, D, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _dump_tree(tmp_path, n=6, seed=3):
    from wavenet_autoencoders_tpu_torch.data.manifest import write_manifest

    rng = np.random.default_rng(seed)
    hop = 160
    rows = []
    for i in range(n):
        N = 24 + 4 * i
        d = tmp_path / f"u{i}"
        d.mkdir()
        prefix = str(d) + "/"
        np.save(prefix + "wave.npy", rng.integers(0, 256, N * hop).astype(np.int16))
        np.save(prefix + "mfcc.norm.npy", rng.standard_normal((N, 39)).astype(np.float32))
        rows.append((prefix, N, i % 3, "x"))
    write_manifest(rows, tmp_path)
    return tmp_path


HP = "max_time_steps=1280,batch_size=4,gin_channels=4,n_speakers=8"


def test_host_slice_equals_the_rows_of_the_full_load(tmp_path):
    """A rank reading only its rows, with the seed shifted by its start,
    gets the full-batch load's crops; through ``data_iterator`` the two
    ranks' slices concatenate to the one-process stream."""
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import (
        _SEED_STRIDE,
        _U64,
        Collator,
        WaveDataset,
        _native_batch,
        data_iterator,
    )

    cfg = load_preset("vqwae", HP)
    ds = WaveDataset(str(_dump_tree(tmp_path)), cfg)
    collate = Collator(cfg)
    full = _native_batch(ds, cfg, [0, 1, 2, 3], collate, 12345)
    for s, n in [(0, 2), (2, 2), (1, 3)]:
        part = _native_batch(ds, cfg, list(range(s, s + n)), collate, (12345 + _SEED_STRIDE * s) % _U64)
        for k in full:
            np.testing.assert_array_equal(part[k], full[k][s : s + n], err_msg=k)
    for use_native in (True, False):
        its = [data_iterator(ds, cfg, prefetch=0, epochs=2, seed=7, use_native=use_native, host_slice=hs)
               for hs in (None, (0, 2), (2, 2))]
        n = 0
        for fb, b0, b1 in zip(*its):
            for k in fb:
                np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]), fb[k], err_msg=k)
            n += 1
        assert n == 2


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_data_iterator_batches_equal_the_jax_package(tmp_path, use_native, jax_native):
    from wavenet_autoencoders_tpu.config import load_preset as jload
    from wavenet_autoencoders_tpu.data.dataset import WaveDataset as JDataset
    from wavenet_autoencoders_tpu.data.dataset import data_iterator as jiter
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator

    root = str(_dump_tree(tmp_path))
    jcfg, cfg = jload("vqwae", HP), load_preset("vqwae", HP)
    want = jiter(JDataset(root, jcfg), jcfg, prefetch=0, epochs=1, seed=5, use_native=use_native)
    got = data_iterator(WaveDataset(root, cfg), cfg, prefetch=0, epochs=1, seed=5, use_native=use_native)
    n = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        n += 1
    assert n == 1


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No g++ on PATH and no library built: loading raises, and so does the
    iterator's native path (no silent fallback to Python)."""
    from wavenet_autoencoders_tpu_torch.config import load_preset
    from wavenet_autoencoders_tpu_torch.data.dataset import WaveDataset, data_iterator

    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()
    cfg = load_preset("vqwae", HP)
    (tmp_path / "d").mkdir()
    ds = WaveDataset(str(_dump_tree(tmp_path / "d")), cfg)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        next(data_iterator(ds, cfg, prefetch=0))
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    bad = tmp_path / "dataload.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not list((tmp_path / "build").iterdir())


def test_concurrent_first_builds_load_one_whole_library(tmp_path, monkeypatch):
    """Builds race into one directory: each writes a temporary file and
    renames it into place, so every racer ends with a loadable library."""
    import ctypes

    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    paths, errors = [], []

    def first_use():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).wae_npy_shape
