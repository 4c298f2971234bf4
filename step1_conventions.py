"""Step 1 of run K, run F and run E on the card, from the JAX package's
initial weights in each of JAX's two threefry key conventions, beside the
JAX runs' logged step 1.

The port draws with the partitionable threefry (``jax_threefry_partitionable``
True, JAX's default since 0.5.0; ``utils/jax_random.py``). With False, JAX
derives keys and bits from one counter run over the whole draw. Which one
the TPU runs used decides whether ``build_model`` reproduces their initial
weights; this script builds the kernels, makes QUALITY.md's sharp corpus
(``chip_smoke.quality_corpus``), and trains one step of each run, fused and
unfused, in each convention, printing each beside the record.

    python3 step1_conventions.py      # on a card: ~150 s
"""
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path


def use_original_convention():
    """Replace ``jax_random``'s split and bits, and the uniform and Bernoulli
    draws made from them, by JAX's ``jax_threefry_partitionable=False``
    forms (of each key of a batch): one threefry over the counter run
    0..2n-1 (split) or 0..size-1, padded to even (bits)."""
    import numpy as np
    import torch

    from wavenet_autoencoders_tpu_torch.kernels import threefry as TF
    from wavenet_autoencoders_tpu_torch.utils import jax_random as jr

    def split(key, num=2):
        c = torch.arange(2 * num, dtype=torch.int64, device=key.device)
        y0, y1 = jr.threefry2x32(key[..., None, :], c[:num], c[num:])
        return torch.cat([y0, y1], dim=-1).reshape(*key.shape[:-1], num, 2)

    def whole(shape, rows):
        if rows is not None and tuple(rows) != (0, shape[0]):
            raise ValueError("the original convention draws no row range of a shape")

    def random_bits(key, shape, rows=None):
        shape = tuple(int(s) for s in shape)
        whole(shape, rows)
        size = math.prod(shape)
        c = torch.arange(size + size % 2, dtype=torch.int64, device=key.device)
        c[size:] = 0
        y0, y1 = jr.threefry2x32(key[..., None, :], c[: c.numel() // 2], c[c.numel() // 2:])
        return torch.cat([y0, y1], dim=-1)[..., :size].reshape(*key.shape[:-1], *shape)

    def uniform(key, shape, minval=0.0, maxval=1.0, rows=None):
        whole(tuple(shape), rows)
        lo, hi = float(np.float32(minval)), float(np.float32(maxval))
        return TF.uniform_of_bits(random_bits(key, shape), lo, float(np.float32(hi) - np.float32(lo)))

    def bernoulli(key, p, shape, rows=None):
        return uniform(key, shape, rows=rows) < float(np.float32(p))

    jr.split, jr.random_bits, jr.uniform, jr.bernoulli = split, random_bits, uniform, bernoulli


def main():
    import chip_smoke as cs
    from wavenet_autoencoders_tpu_torch.kernels import build
    from wavenet_autoencoders_tpu_torch.quality import recon, run

    print(cs.smi(), flush=True)
    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        q = cs.quality_corpus(Path(tmp), timed, "step1")["q"]
        for convention in ("partitionable", "original"):
            if convention == "original":
                use_original_convention()
            for spec in (cs.QUALITY_RUNS[13], cs.QUALITY_RUNS[15], cs.QUALITY_RUNS[17]):
                ref_dir = cs.QUALITY / "exp" / spec.run
                ref = recon.read_metrics(ref_dir)[0][0]
                for hp in ("fused_stack=true", "fused_stack=false"):
                    exp = q / "exp" / "step1"
                    run.train_main(["--root", str(q), "--exp", "exp/step1", "--steps", str(spec.steps),
                                    "--max-steps", "1", "--preset", str(ref_dir / "config.json"), "--hparams", hp])
                    got = recon.read_metrics(exp)[0][0]
                    shutil.rmtree(exp)
                    name = f"{spec.label} {convention} {hp}"
                    out[name] = {k: (got[k], ref[k]) for k in cs.TOL_RECORD_STEP1}
                    print(f"STEP1 {name}: " + "; ".join(
                        f"{k} {g:.6g} ({spec.label} {r:.6g}, rel {abs(g - r) / abs(r) if r else 0.0:.2e})"
                        for k, (g, r) in out[name].items()), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main()
