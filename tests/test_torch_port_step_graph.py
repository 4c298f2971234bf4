"""The train step as one device program (``train/step.py``'s body and host
part, ``train/graph.py``), on the CPU.

On the card the step's body is captured as a CUDA graph and replayed;
chip_smoke phases 7 and 16 hold the graphed step against the eager body
there. What the CPU can hold:

(a) the body reads no device value on the host and copies nothing from
    it: while it runs, ``Tensor.item``, ``__bool__``, ``__float__``,
    ``__int__``, ``tolist``, ``numpy`` and ``cpu``, ``torch.tensor``, and
    ``torch.arange``, ``zeros``, ``ones``, ``full`` and ``empty`` without a
    device (a tensor made on the host and moved to the card is a copy that
    a graph cannot capture), raise; every family of the
    zoo at 4 layers, with every option on (decoder dropout; for the VQ
    families time jitter past its gate, VQ-dropout, EMA codebooks, reseed
    past ``vq_reseed_start`` and the commitment ramp; the Gumbel families'
    noise), three steps each;
(b) the body fed through its static inputs, eagerly and through
    ``GraphedStep`` (with its CUDA calls replaced by their CPU equivalents,
    ``CpuGraph``), equals the step as it was before the split, with its
    per-step values as Python numbers (``reference_step``), bit for bit in
    every metric and every state tensor over 16 steps of run K's narrowed
    config across its schedule's events: the ramp's end, the jitter gate
    opening at step 3, revival turning active at step 5 and the lr halving
    at step 10. The one change the split makes is kept in the reference:
    the update is ``p − lr·upd`` (optax's ``u = −lr·upd``, then ``p + u``),
    where the step before it added ``upd`` with ``alpha=−lr``, which the
    CPU fuses into one multiply-add;
(c) the metrics a graphed step returns are copies: step n's, read after
    step n + 1, are step n's; and the loop over a graphed step writes the
    eager loop's log;
(d) the pointer check: a graphed step raises after ``load_checkpoint``
    rebinds the Adam moments; and no reference cycle keeps a dropped step's
    graph alive.
"""
import contextlib
import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_port_loop_parity import _dump  # noqa: E402
from test_torch_port_quality_runs import quality_batch, quality_cfgs  # noqa: E402
from wavenet_autoencoders_tpu_torch.config import load_preset  # noqa: E402
from wavenet_autoencoders_tpu_torch.models import build_model  # noqa: E402
from wavenet_autoencoders_tpu_torch.train import loop  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from wavenet_autoencoders_tpu_torch import kernels  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.graph import GraphedStep, StatePointers, state_tensors  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.schedule import get_schedule  # noqa: E402
from wavenet_autoencoders_tpu_torch.train.step import (  # noqa: E402
    ADAM_B1,
    ADAM_B2,
    ReseedDraws,
    init_state,
    make_train_step,
    objective,
    prep_x,
)
from wavenet_autoencoders_tpu_torch.utils import jax_random as jr  # noqa: E402
from wavenet_autoencoders_tpu_torch.utils.params import flatten_params  # noqa: E402


class CpuGraph(GraphedStep):
    """``GraphedStep`` with its CUDA calls replaced for the CPU: the first
    step runs the body as it is; the "capture" records the body over the
    static batch buffers; a "replay" runs it and writes its outputs into the
    tensors the first replay returned, as a CUDA graph's replay overwrites
    its outputs."""

    def _warm(self, body, state):
        return body(state, self.static)

    def _capture(self, body, state):
        self.graph = lambda: body(state, self.static)
        self.launches = dict.fromkeys(kernels.COUNTERS, 0)
        self.pointers = StatePointers(state)

    def _replay(self):
        out = self.graph()
        if self.out is None:
            self.out = out
        else:
            for k, v in out.items():
                self.out[k].copy_(v)


def cpu_graphed(cfg, model):
    step = make_train_step(cfg, model)
    step.runner = CpuGraph(step.device)
    return step


# ---------------------------------------------------------------------------
# (a) no host reads
# ---------------------------------------------------------------------------

TINY = ("layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,encoder_hid=16,"
        "cin_channels=8,gin_channels=4,n_speakers=8,K=8,num_slices=4,max_time_steps=128,hop_size=4,"
        "compute_dtype=float32")
MULAW = "out_channels=32,quantize_channels=32"
RAW = "gin_channels=-1,out_channels=30,quantize_channels=256"
VQ_OPTIONS = ("time_jitter=true,time_jitter_start=1,vq_drop=true,drop_dim=2,vq_reseed=true,vq_reseed_start=1,"
              "vq_reseed_thresh=0.9,vq_warmup_steps=4")
# name: (preset, overrides, feature frames for T=32 samples, feature dim)
FAMILIES = {
    "svqwae": ("svqwae", f"{MULAW},dropout=0.1,{VQ_OPTIONS}", 32, 39),
    "svqwae_fused": ("svqwae", f"{MULAW},fused_stack=true,{VQ_OPTIONS}", 32, 39),
    "svqwae_ema": ("svqwae", f"{MULAW},dropout=0.1,ema=true,{VQ_OPTIONS}", 32, 39),
    "vqwae": ("vqwae", f"{MULAW},dropout=0.1,{VQ_OPTIONS}", 32, 39),
    "wvae": ("wvae", f"{MULAW},dropout=0.1", 16, 39),
    "ae": ("ae", f"{MULAW},dropout=0.1", 8, 39),
    "inae": ("inae", f"{MULAW},dropout=0.1", 16, 39),
    "inae1": ("inae", f"{MULAW},dropout=0.1,name=inae1", 16, 39),
    "new_inae": ("new_inae", f"{MULAW},dropout=0.1", 16, 39),
    "catae": ("catae", f"{MULAW},dropout=0.1", 32, 39),
    "catae_hard": ("catae", f"{MULAW},dropout=0.1,hard=true", 32, 39),
    "vocoder": ("vocoder", f"{MULAW},dropout=0.1", 8, 8),
    "vocoder_raw": ("vocoder_raw", f"{RAW},dropout=0.1,cin_pad=2", 12, 8),
    "vocoder_normal": ("vocoder_raw", f"{RAW},dropout=0.1,output_distribution=Normal,cin_pad=0", 8, 8),
    "mfcc_ae": ("ae", "name=model2,cin_channels=39,frame_rate=50", 16, 39),
    "cat_mfcc_ae": ("ae", "name=cat_ae,cin_channels=39,frame_rate=25", 16, 39),
}
HOST_READS = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy", "cpu")
FACTORIES = ("arange", "zeros", "ones", "full", "empty")


def family_cfg(family):
    preset, hp, _, _ = FAMILIES[family]
    return load_preset(preset, f"{TINY},{hp}").replace(upsample_params={"upsample_scales": [2, 2]}, clip_thresh=1.0)


def family_batch(family, seed=0, B=2, T=32):
    cfg = family_cfg(family)
    _, _, frames, dim = FAMILIES[family]
    rng = np.random.default_rng(seed)
    if cfg.is_mulaw_quantize:
        x = torch.from_numpy(rng.integers(0, 32, (B, T)))
    else:
        x = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, T)).astype(np.float32))
    b = {"x": x, "y": x[..., None], "c": torch.from_numpy(rng.standard_normal((B, frames, dim)).astype(np.float32)),
         "lengths": torch.tensor([T, T - 5])}
    if cfg.gin_channels > 0:
        b["g"] = torch.tensor([1, 5])
    return b


@contextlib.contextmanager
def no_host_reads():
    """Inside the block every way to read a tensor on the host raises."""
    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"the step's body read a device value on the host: {name}")
        return read

    def on_a_device(name):
        make = getattr(torch, name)

        def factory(*a, **k):
            if k.get("device") is None:  # made on the host, it would be copied to the card
                refuse(f"torch.{name} without a device")()
            return make(*a, **k)
        return factory

    with pytest.MonkeyPatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        mp.setattr(torch, "tensor", refuse("torch.tensor"))
        for name in FACTORIES:
            mp.setattr(torch, name, on_a_device(name))
        yield


def test_the_guard_catches_each_host_read():
    t = torch.ones(())
    reads = [lambda: t.item(), lambda: bool(t), lambda: float(t), lambda: int(t), lambda: t.tolist(),
             lambda: t.numpy(), lambda: t.cpu(), lambda: torch.tensor(1.0)]
    reads += [lambda name=name: getattr(torch, name)(2) for name in FACTORIES if name != "full"]
    reads += [lambda: torch.full((2,), 1.0)]
    with no_host_reads():
        for read in reads:
            with pytest.raises(AssertionError, match="read a device value"):
                read()
    assert all(read() is not None for read in reads)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_body_reads_no_device_value_on_the_host(family):
    cfg = family_cfg(family)
    model = build_model(cfg, device="cpu").train()
    step = make_train_step(cfg, model)
    body = step.body

    def guarded(*a, **k):
        with no_host_reads():
            return body(*a, **k)

    step.body = guarded
    st = init_state(cfg, model)
    for i in range(3):
        st, m = step(st, family_batch(family, seed=i))
        assert all(np.isfinite(float(v)) for v in m.values()), (family, i, m)
    if family.startswith(("svqwae", "vqwae")):
        assert model.use_time_jitter and model.vq_drop and model.reseed and cfg.vq_warmup_steps == 4
    assert st.step == 3


# ---------------------------------------------------------------------------
# (b) the static-input body against the step before the split
# ---------------------------------------------------------------------------

STEPS = 16
SCHEDULE = dict(vq_warmup_steps=3, vq_reseed=True, vq_reseed_start=5, vq_reseed_thresh=0.9, vq_reseed_decay=0.5,
                time_jitter=True, time_jitter_start=3,
                lr_schedule_kwargs={"anneal_interval": 10, "anneal_rate": 0.5},
                optimizer_params={"lr": 4e-5, "eps": 1e-6, "weight_decay": 0.0})


def reference_step(cfg, model):
    """The train step before its body/host split (one process), its
    per-step values Python numbers: the step key folded from the host's
    step, the ramp, lr and bias corrections as scalars, the jitter skipped
    while its gate is shut, revival's switch a bool; the update in optax's
    order (see the module's docstring)."""
    names = list(flatten_params(model))
    op = cfg.optimizer_params
    schedule = get_schedule(cfg.lr_schedule, float(op["lr"]), cfg.lr_schedule_kwargs)
    base = jr.PRNGKey(cfg.seed + 1)
    draws = ReseedDraws(cfg, model._codebook_sizes(), "cpu")
    warmup, clip, eps = cfg.vq_warmup_steps, cfg.clip_thresh, float(op["eps"])

    def step(state, batch):
        plist = [state.params()[k] for k in names]
        for p in plist:
            p.grad = None
        x = prep_x(cfg, batch["x"])
        gate = state.step >= cfg.time_jitter_start
        model.use_time_jitter = gate
        y_hat, aux, perp = model.forward(x, batch["c"], batch["g"], train=True, key=jr.fold_in(base, state.step),
                                         jitter_scale=1.0 if gate else None)
        model.use_time_jitter = True
        recon = objective(cfg, model, y_hat, batch, x.shape[1])
        ramp = min(max(state.step / warmup, 0.0), 1.0)
        loss = recon + ramp * aux
        loss.backward()
        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            grads = torch._foreach_mul(grads, torch.clamp(clip / torch.clamp(gnorm, min=1e-6), max=1.0))
            lr = schedule(state.step)
            state.count += 1
            mu, nu = [state.mu[k] for k in names], [state.nu[k] for k in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** state.count)
            den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - ADAM_B2 ** state.count))
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu_hat, den)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(plist, upd)
            state.lr = lr
            reseeded = model.revive(state.step >= model.reseed_start, draws(state.step))
            torch._foreach_lerp_([state.ema[k] for k in names], plist, 1.0 - cfg.ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "recon_loss": recon.detach(), "aux_loss": aux.detach(),
                       "perplexity": perp.detach(), "grad_norm": gnorm, "lr": torch.tensor(lr), "reseeded": reseeded}

    return step


def assert_states_equal(a, b, where):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), f"{where}: {k} differs by {float((ta[k] - tb[k]).abs().max()):g}"
    assert (a.step, a.count, a.lr) == (b.step, b.count, b.lr), where


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("form", ["eager", "graphed"])
def test_the_static_input_body_is_the_step_before_the_split(form, fused):
    _, cfg = quality_cfgs("run_K", fused_stack=fused, **SCHEDULE)
    runs = {}
    for name in ("reference", form):
        model = build_model(cfg, device="cpu").train()
        step = {"reference": reference_step, "eager": make_train_step, "graphed": cpu_graphed}[name](cfg, model)
        runs[name] = (init_state(cfg, model), step)
    assert runs[form][1].jitter_start == 3 and runs[form][1].reseed
    reseeded, lrs = [], []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in quality_batch(seed=i % 4).items()}
        out = {name: step(st, batch)[1] for name, (st, step) in runs.items()}
        for k, want in out["reference"].items():
            assert torch.equal(out[form][k], want), f"step {i + 1} {k}: {out[form][k]} against {want}"
        assert_states_equal(runs[form][0], runs["reference"][0], f"step {i + 1}")
        reseeded.append(float(out[form]["reseeded"]))
        lrs.append(float(out[form]["lr"]))
    # the schedule's events happened: revival from step 5 (state.step 4 -> 5), the lr halving at step 11
    assert not any(reseeded[:5]) and any(reseeded[5:]), reseeded
    assert lrs[9] == lrs[0] and lrs[10] == lrs[0] / 2
    if form == "graphed":
        assert isinstance(runs[form][1].runner, CpuGraph) and runs[form][1].runner.graph is not None


# ---------------------------------------------------------------------------
# (c) metric snapshots; the loop over a graphed step
# ---------------------------------------------------------------------------


def test_a_graphed_steps_metrics_are_its_own_after_the_next_step():
    _, cfg = quality_cfgs("run_K", **SCHEDULE)
    batches = [{k: torch.from_numpy(v) for k, v in quality_batch(seed=i).items()} for i in range(5)]
    read_at_once, kept = [], []
    for make, out in ((make_train_step, read_at_once), (cpu_graphed, kept)):
        model = build_model(cfg, device="cpu").train()
        st, step = init_state(cfg, model), make(cfg, model)
        for b in batches:
            st, m = step(st, b)
            out.append({k: float(v) for k, v in m.items()} if make is make_train_step else m)
    kept = [{k: float(v) for k, v in m.items()} for m in kept]
    assert kept == read_at_once
    assert len({m["loss"] for m in kept}) == len(kept)  # each step's own


def test_the_loop_over_a_graphed_step_writes_the_eager_loops_log(tmp_path, monkeypatch, capsys):
    _, cfg = quality_cfgs("run_K", **{**SCHEDULE, "checkpoint_interval": 3})
    dump = _dump(tmp_path / "train", 8, 30)
    loop.train(cfg, str(dump), str(tmp_path / "eager"), max_steps=8, log_every=1, device="cpu")
    assert "train step: eager (the model is on the CPU)" in capsys.readouterr().out
    monkeypatch.setattr(loop, "make_train_step", cpu_graphed)
    loop.train(cfg, str(dump), str(tmp_path / "graphed"), max_steps=8, log_every=1, device="cpu")
    assert "train step: CUDA graph, captured at step 2 (step 1 eager)" in capsys.readouterr().out

    def records(d):
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "samples_per_sec")}
                for line in (d / "logs" / "metrics.jsonl").read_text().splitlines()]

    got, want = records(tmp_path / "graphed"), records(tmp_path / "eager")
    assert got == want and sum(r["phase"] == "train_no_dev_epoch" for r in got) == 2
    for name in ("checkpoint_step000000006.npz", "checkpoint_step000000008_ema.npz"):
        a, b = np.load(tmp_path / "graphed" / name), np.load(tmp_path / "eager" / name)
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files), name


# ---------------------------------------------------------------------------
# (d) the pointer check; where the graph cannot be had
# ---------------------------------------------------------------------------


def test_a_graphed_step_raises_after_load_checkpoint_rebinds_a_moment(tmp_path):
    _, cfg = quality_cfgs("run_K", **SCHEDULE)
    model = build_model(cfg, device="cpu").train()
    st, step = init_state(cfg, model), cpu_graphed(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in quality_batch().items()}
    for _ in range(3):  # eager, captured, replayed
        st, _ = step(st, batch)
    path = save_checkpoint(st, tmp_path)
    st, _ = step(st, batch)  # in place: the pointers hold
    before = state_tensors(st)["mu/encoder/lin/w"].data_ptr()
    load_checkpoint(st, path)
    assert state_tensors(st)["mu/encoder/lin/w"].data_ptr() != before
    with pytest.raises(RuntimeError, match=r"tensors of the train state were rebound .*mu: "):
        step(st, batch)


def test_state_pointers_hold_in_place_updates_and_catch_each_rebinding():
    _, cfg = quality_cfgs("run_K", **SCHEDULE)
    model = build_model(cfg, device="cpu").train()
    st = init_state(cfg, model)
    ptrs = StatePointers(st)
    with torch.no_grad():
        for t in state_tensors(st).values():
            t.add_(1.0)
    ptrs.check(st)
    for tree in ("mu", "nu", "ema"):
        old = getattr(st, tree)["encoder/lin/w"]
        getattr(st, tree)["encoder/lin/w"] = old.clone()
        with pytest.raises(RuntimeError, match=f"{tree}/encoder/lin/w"):
            ptrs.check(st)
        getattr(st, tree)["encoder/lin/w"] = old
    model.usage._buffers["0"] = model.usage[0].clone()
    with pytest.raises(RuntimeError, match="model_state/usage/0"):
        ptrs.check(st)


def test_a_train_step_and_its_graph_are_freed_without_the_collector():
    """No reference cycle holds a train step with its graph: a dead graph
    that Python's collector frees inside a later capture invalidates that
    capture (as it did on the card when a run captured a step after another
    run's)."""
    _, cfg = quality_cfgs("run_K", **SCHEDULE)
    model = build_model(cfg, device="cpu").train()
    step = make_train_step(cfg, model)
    step.runner = GraphedStep(step.device)
    refs = (weakref.ref(step), weakref.ref(step.runner))
    collecting = gc.isenabled()
    gc.disable()
    try:
        del step
        assert [r() for r in refs] == [None, None]
    finally:
        if collecting:
            gc.enable()


def test_the_graph_is_refused_where_it_cannot_be_had():
    _, cfg = quality_cfgs("run_K", **SCHEDULE)
    model = build_model(cfg, device="cpu").train()
    with pytest.raises(ValueError, match="needs the model on cuda"):
        make_train_step(cfg, model, graph=True)
    assert make_train_step(cfg, model).runner is None
    assert make_train_step(cfg, model).form(0) == "eager (the model is on the CPU)"
    step = cpu_graphed(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in quality_batch().items()}
    st, _ = step(init_state(cfg, model), batch)
    with pytest.raises(ValueError, match="first batch's keys, shapes and dtypes"):
        step(st, {k: v[:1] for k, v in batch.items()})


def test_the_warm_step_runs_on_the_callers_stream(monkeypatch):
    """``GraphedStep``'s own eager first step (not the test double's) runs
    the body on the caller's stream and opens no side stream: warmed on a
    side stream, the card's replays ran ~1.2 ms a step slower until a
    random later step (``train/graph.py``)."""

    def no_side_stream(*a, **kw):
        raise AssertionError("the warm step opened a side stream")

    monkeypatch.setattr(torch.cuda, "Stream", no_side_stream)
    monkeypatch.setattr(torch.cuda, "stream", no_side_stream)
    seen = []
    step = GraphedStep(torch.device("cpu"))
    out = step(lambda state, batch: seen.append((state, batch)) or {"loss": batch["x"].sum()}, "state",
               {"x": torch.ones(3)})
    assert float(out["loss"]) == 3.0 and seen[0][0] == "state" and seen[0][1] is step.static
    assert step.graph is None  # the first call captures nothing
