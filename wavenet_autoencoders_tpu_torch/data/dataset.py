"""Host-side dataset: lazy npy loading, length-bucketed sampling,
hop-aligned random cropping, fixed-shape batch assembly (counterpart of
``wavenet_autoencoders_tpu/data/dataset.py``).

Batches are fixed shape (crop length = max_time_steps for every item;
shorter utterances are filtered out); waveforms stay compact on the host
(int mu-law codes), and a background thread prefetches batches. Mu-law
batches come from the native C++ loader (``data.native``: mmap, parallel
crops from per-item seeds) as in the JAX package, so both packages train on
the same crops of a dump for a seed; scalar input, and npy files the loader
refuses, take the Python ``Collator``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from wavenet_autoencoders_tpu_torch.config import Config
from wavenet_autoencoders_tpu_torch.data.manifest import Manifest
from wavenet_autoencoders_tpu_torch.dsp.mulaw import mulaw_quantize


def ensure_divisible(length: int, divisible_by: int, lower: bool = True) -> int:
    if length % divisible_by == 0:
        return length
    if lower:
        return length - length % divisible_by
    return length + (divisible_by - length % divisible_by)


class WaveDataset:
    """Pairs (wave, conditioning features, speaker) from a dump dir.

    feat_type: 'mfcc' (autoencoders) or 'mel' (vocoder); norm selects the
    CMVN-normalized variant.
    """

    def __init__(
        self,
        dump_root: str,
        cfg: Config,
        feat_type: str = "mfcc",
        norm: bool = True,
        speaker_id: int | None = None,
        min_length: int | None = None,
    ):
        self.cfg = cfg
        self.feat_type = feat_type
        self.norm = norm
        man = Manifest.read(dump_root)
        hop = cfg.get_hop_size()
        if min_length is None:
            if cfg.max_time_steps is not None:
                min_length = cfg.max_time_steps + 2 * cfg.cin_pad * hop
            else:
                min_length = 0
        utts = [u for u in man.utterances if u.n_frames * hop > min_length]
        if speaker_id is not None:
            utts = [u for u in utts if u.speaker_id == speaker_id]
        n_drop = len(man) - len(utts)
        if n_drop:
            print(f"{n_drop} short samples are omitted for training.")
        self.utterances = utts
        self.multi_speaker = man.multi_speaker and speaker_id is None

    def __len__(self):
        return len(self.utterances)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([u.n_frames for u in self.utterances])

    def __getitem__(self, idx: int):
        u = self.utterances[idx]
        wave = np.load(u.path("wave"))
        feats = np.load(u.path(self.feat_type, norm=self.norm))
        g = u.speaker_id if self.multi_speaker else None
        return wave, feats, g


class LengthBucketSampler:
    """Sort by length, shuffle inside groups of 8*batch_size, permute the
    groups."""

    def __init__(self, lengths, batch_size: int, batch_group_size: int | None = None, seed: int = 0):
        self.sorted_indices = np.argsort(lengths)
        self.batch_size = batch_size
        if batch_group_size is None:
            batch_group_size = min(batch_size * 8, len(lengths))
            batch_group_size -= batch_group_size % batch_size
        self.batch_group_size = max(batch_group_size, batch_size)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = self.sorted_indices.copy()
        gs = self.batch_group_size
        bins = []
        for i in range(len(idx) // gs):
            group = idx[i * gs : (i + 1) * gs]
            self.rng.shuffle(group)
            bins.append(group)
        if bins:
            order = self.rng.permutation(len(bins))
            binned = np.concatenate([bins[i] for i in order])
        else:
            binned = np.array([], dtype=np.int64)
        tail = idx[len(binned):]
        self.rng.shuffle(tail)
        return iter(np.concatenate([binned, tail]).astype(int))

    def __len__(self):
        return len(self.sorted_indices)


@dataclass
class Collator:
    """Hop-aligned random crop + fixed-shape batch assembly."""

    cfg: Config
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        cfg = self.cfg
        hop = cfg.get_hop_size()
        if cfg.max_time_sec is not None:
            mts = int(cfg.max_time_sec * cfg.sample_rate)
        else:
            mts = cfg.max_time_steps
        if mts is None:
            raise ValueError("fixed-shape batching needs max_time_steps")
        self.max_steps = ensure_divisible(mts, hop, True)
        self.max_frames = self.max_steps // hop
        # latent frames must divide evenly into the encoder downsampling
        ds = 100 // cfg.frame_rate
        if self.max_frames % ds:
            raise ValueError(f"max_time_steps/hop={self.max_frames} not divisible by 100/frame_rate={ds}")
        if not cfg.upsample_conditional_features and cfg.cin_pad != 0:
            # a plain frame repeat cannot carry a cin_pad context window
            raise ValueError("upsample_conditional_features=false requires cin_pad=0")

    def __call__(self, items) -> dict:
        cfg = self.cfg
        hop = cfg.get_hop_size()
        cin_pad = cfg.cin_pad
        xs, cs, gs, lengths = [], [], [], []
        for wave, feats, g in items:
            # hop-aligned synchronized crop
            if len(wave) != len(feats) * hop:
                raise ValueError("wave/frames misaligned")
            if len(feats) > self.max_frames + 2 * cin_pad:
                s = self.rng.integers(cin_pad, len(feats) - self.max_frames - cin_pad + 1)
            else:
                s = cin_pad
            ts = s * hop
            x = wave[ts : ts + self.max_steps]
            c = feats[s - cin_pad : s + self.max_frames + cin_pad]
            xs.append(x)
            cs.append(c)
            gs.append(-1 if g is None else g)
            lengths.append(len(x))

        x_b = np.stack(xs)
        c_b = np.stack(cs).astype(np.float32)
        batch = {
            "c": c_b,
            "lengths": np.array(lengths, np.int32),
        }
        if cfg.is_mulaw_quantize:
            batch["x"] = x_b.astype(np.int32)
            batch["y"] = x_b.astype(np.int32)[..., None]
        else:
            batch["x"] = x_b.astype(np.float32)
            batch["y"] = x_b.astype(np.float32)[..., None]
        if cfg.gin_channels > 0:
            batch["g"] = np.array(gs, np.int32)
        return batch

    @property
    def pad_value(self) -> int:
        # mulaw_quantize(0, 255) == 127
        return int(mulaw_quantize(0, self.cfg.quantize_channels - 1))


# the per-item seed stride of native/dataload.cpp (wae_load_batch: item i
# crops from seed + _SEED_STRIDE * (i + 1)): a rank that loads only the
# slice [s, s + n) of the global batch shifts the batch seed by s strides
# and gets the full load's crops bit for bit
_SEED_STRIDE = 0x517CC1B727220A95
_U64 = 1 << 64


def _native_batch(dataset: WaveDataset, cfg: Config, idxs, collate: Collator, seed: int):
    """One batch through the native loader, or None for what the loader
    does not take (scalar input; an npy it refuses), which the caller
    collates in Python. A loader that fails to build or load raises."""
    from wavenet_autoencoders_tpu_torch.data import native

    if not cfg.is_mulaw_quantize:
        return None
    utts = [dataset.utterances[i] for i in idxs]
    try:
        x, c = native.load_batch_native(
            [u.path("wave") for u in utts],
            [u.path(dataset.feat_type, norm=dataset.norm) for u in utts],
            collate.max_steps,
            cfg.get_hop_size(),
            cfg.cin_pad,
            cfg.dim_in if dataset.feat_type == "mfcc" else cfg.num_mels,
            seed,
        )
    except native.LoaderRefused:
        return None
    batch = {
        "x": x,
        "y": x[..., None],
        "c": c,
        "lengths": np.full((len(utts),), collate.max_steps, np.int32),
    }
    if cfg.gin_channels > 0:
        batch["g"] = np.array([(-1 if not dataset.multi_speaker else u.speaker_id) for u in utts], np.int32)
    return batch


def data_iterator(
    dataset: WaveDataset,
    cfg: Config,
    batch_size: int | None = None,
    seed: int = 0,
    prefetch: int = 3,
    epochs: int | None = None,
    use_native: bool = True,
    host_slice: tuple[int, int] | None = None,
    transform=None,
):
    """Yield collated batches forever (or for ``epochs``), assembled in a
    background thread ``prefetch`` batches ahead; mu-law batches through the
    native loader unless ``use_native`` is false.

    host_slice=(start, size): data-parallel mode. Every rank runs the same
    sampler over the global batch and yields only its slice of it. On the
    native path a rank reads only its slice's files, with the crops of the
    full-batch load; the Python path collates the full batch and slices it
    (its crop stream is sequential).

    transform: optional per-batch function applied INSIDE the prefetch
    thread; the training loop passes the host-to-device copy (pinned memory,
    ``non_blocking=True``) so the copy overlaps device compute.
    """
    bs = batch_size or cfg.batch_size
    sampler = LengthBucketSampler(dataset.lengths, bs, seed=seed)
    collate = Collator(cfg, seed=seed)
    s, n = host_slice if host_slice is not None else (0, bs)

    def gen():
        epoch = 0
        step = 0
        while epochs is None or epoch < epochs:
            buf = []
            for idx in sampler:
                buf.append(idx)
                if len(buf) == bs:
                    step += 1
                    b = None
                    if use_native:
                        seed_s = (seed + step * 7919 + _SEED_STRIDE * s) % _U64
                        b = _native_batch(dataset, cfg, buf[s : s + n], collate, seed_s)
                    if b is None:
                        b = collate([dataset[i] for i in buf])
                        if host_slice is not None:
                            b = {k: v[s : s + n] for k, v in b.items()}
                    yield b
                    buf = []
            epoch += 1

    if prefetch <= 0:
        for b in gen():
            yield transform(b) if transform is not None else b
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    _END = object()
    failure = []

    def worker():
        try:
            for b in gen():
                q.put(transform(b) if transform is not None else b)
        except Exception as e:  # handed to the consumer, which re-raises it
            failure.append(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        b = q.get()
        if b is _END:
            if failure:
                raise failure[0]
            break
        yield b
