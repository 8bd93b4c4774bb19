"""The port's training runtime on its own (CPU): twins of the reference's
``tests/test_train.py`` and of ``tests/test_system.py::
test_lm_train_then_serve``, run on ``repro_torch`` alone.

  * granite's smoke config learns the seeded bigram corpus (the loss
    falls by more than 0.1), also with int8 gradient compression;
  * a run that fails at step 17 and restarts from its step-10 checkpoint
    gives losses ``==`` those of an uninterrupted run (the data stream
    fast-forwarded, as a deterministic loader does);
  * four microbatches give one big batch's loss and update;
  * the trained weights serve through ``ServeLoop``;
  * a training step reaches none of the four kernel wrappers: with each
    replaced by one that raises, the step still completes.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus, packed_batches
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ou_mvm as tou
from repro_torch.kernels import pattern_spmm as tk
from repro_torch.models import layers as tl
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import apply_model, init_params
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import _leaves
from repro_torch.runtime import (
    FailureInjector,
    SimulatedFailure,
    StragglerDetector,
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
)
from repro_torch.runtime.serve import ServeConfig, ServeLoop
from repro_torch.serve.api import Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp_path, steps=30, **tkw):
    cfg = get_smoke_config("granite_3_2b")
    params, statics = init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(
        steps=steps, ckpt_every=10, ckpt_dir=str(tmp_path / "ckpt"), **tkw
    )
    step = make_train_step(cfg, statics, opt, lambda s: 2e-3, tcfg)
    state = init_train_state(params, opt, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    return cfg, step, state, dcfg, tcfg


def _falls(hist) -> tuple[float, float]:
    return (np.mean([h["loss"] for h in hist[:5]]),
            np.mean([h["loss"] for h in hist[-5:]]))


def test_loss_decreases(tmp_path):
    cfg, step, state, dcfg, tcfg = _setup(tmp_path, steps=30)
    hist = Trainer(step, state, packed_batches(dcfg), tcfg).run()
    first, last = _falls(hist)
    assert last < first - 0.1, f"no learning: {first:.3f} -> {last:.3f}"


def test_checkpoint_restart_bit_exact(tmp_path):
    """Crash at step 17, restore from step 10, rerun -> losses equal to
    an uninterrupted run's, and the final states equal bit for bit."""
    cfg, step, state, dcfg, tcfg = _setup(tmp_path / "a", steps=25)
    ref = Trainer(step, state, packed_batches(dcfg), tcfg)
    ref_hist = ref.run()

    cfg, step, state, dcfg, tcfg = _setup(tmp_path / "b", steps=25)
    injector = FailureInjector({17: "node-failure"})
    tr = Trainer(step, state, packed_batches(dcfg), tcfg, injector=injector)
    with pytest.raises(SimulatedFailure):
        tr.run()
    cfg, step, state2, dcfg, tcfg = _setup(tmp_path / "b", steps=25)
    batches = packed_batches(dcfg)
    tr2 = Trainer(step, state2, batches, tcfg, injector=FailureInjector())
    resumed = tr2.maybe_restore()
    assert resumed == 10
    assert tr2.state["step"].dtype == torch.int32
    for _ in range(resumed):
        next(batches)  # deterministic fast-forward
    hist2 = tr2.run()

    ref_tail = {h["step"]: h["loss"] for h in ref_hist if h["step"] >= 10}
    assert [h["step"] for h in hist2] == list(range(10, 25))
    for h in hist2:
        assert h["loss"] == ref_tail[h["step"]], (
            f"divergence at step {h['step']}")
    for a, b in zip(_leaves(ref.state), _leaves(tr2.state)):
        assert torch.equal(a, b)


def test_straggler_detection():
    """Twin of the reference's test (``runtime.fault`` through
    ``repro_torch.runtime``)."""
    det = StragglerDetector(window=20, threshold=2.0)
    for i in range(10):
        det.record(i, 0.1)
    assert det.record(10, 0.5) is True
    assert det.record(11, 0.11) is False
    assert det.flagged and det.flagged[0][0] == 10


def test_grad_compression_training_parity(tmp_path):
    """Compressed training converges on the same task."""
    cfg, step, state, dcfg, tcfg = _setup(
        tmp_path, steps=30, grad_compression=True
    )
    assert set(state) == {"params", "opt_state", "step", "comp_state"}
    hist = Trainer(step, state, packed_batches(dcfg), tcfg).run()
    first, last = _falls(hist)
    assert last < first - 0.1


def test_microbatching_matches_full_batch():
    """Gradient accumulation over 4 microbatches == one big batch (same
    data, same init) up to numerics: the loss to 1e-5, the update to 5 %
    of one step (the reference's bound)."""
    cfg = get_smoke_config("granite_3_2b")
    params, statics = init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    opt = adamw(weight_decay=0.0)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 33)))}
    outs = {}
    for nmb in (1, 4):
        tcfg = TrainConfig(steps=1, microbatches=nmb)
        step = make_train_step(cfg, statics, opt, lambda s: 1e-2, tcfg)
        new_state, m = step(init_train_state(params, opt, tcfg), batch)
        outs[nmb] = (m["loss"], new_state["params"])
    np.testing.assert_allclose(float(outs[1][0]), float(outs[4][0]),
                               rtol=1e-5)
    lr = 1e-2
    deltas = [float((a - b).abs().max())
              for a, b in zip(_leaves(outs[1][1]), _leaves(outs[4][1]))]
    assert max(deltas) < 0.05 * lr


def test_lm_train_then_serve(tmp_path):
    """Train a small LM on the bigram corpus, then serve it: greedy
    continuations must be valid tokens from a trained model."""
    cfg = get_smoke_config("granite_3_2b")
    params, statics = init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=40, ckpt_every=40, ckpt_dir=str(tmp_path))
    step = make_train_step(cfg, statics, opt, lambda s: 3e-3, tcfg)
    state = init_train_state(params, opt, tcfg)
    corpus = SyntheticCorpus(cfg.vocab, seed=3)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    trainer = Trainer(step, state, packed_batches(dcfg, corpus), tcfg)
    hist = trainer.run()
    assert hist[-1]["loss"] < hist[0]["loss"]

    scfg = ServeConfig(batch_slots=4, max_seq=48, eos_id=-1)
    loop = ServeLoop(cfg, statics, trainer.state["params"], scfg,
                     device="cpu")
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
                max_new_tokens=8)
        for _ in range(4)
    ]
    loop.generate(reqs)
    for r in reqs:
        assert len(r.output) == 8
        assert all(0 <= t < cfg.vocab for t in r.output)


def _kernel_route_model(arch):
    """(cfg, params, statics, batch, model_kwargs_fn) of a smoke model
    whose forward reaches kernel routes: h2o-danube with pattern-sparse
    MLPs, its first layer's up projection ungrouped (the ``block_ids``
    table alone, which ``ops.pattern_spmm_raw`` takes), or whisper (its
    decoder's and its encoder's self-attention prefills group, 4 heads
    over 4)."""
    cfg = get_smoke_config(arch)
    if arch == "h2o_danube_1_8b":
        cfg = dataclasses.replace(cfg, d_ff=384, model_shards=4,
                                  sparse=PatternSparseConfig(
                                      density=0.5, num_patterns=3, block=32,
                                      tile=32))
    params, statics = init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    if cfg.sparse is not None:
        statics["body"][0]["mlp"]["up"]["groups"] = []
    rows = np.random.default_rng(1).integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": torch.as_tensor(rows)}
    kw = None
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(
            (2, cfg.enc_seq, cfg.d_model),
            generator=torch.Generator().manual_seed(2))
        kw = lambda b: {"frames": b["frames"]}  # noqa: E731
    return cfg, params, statics, batch, kw


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "whisper_small"])
def test_apply_model_plain_routes(monkeypatch, arch):
    """``apply_model(..., kernels=False)`` calls no kernel op (the default
    calls the flash op at every grouped prefill and the spmm op at the
    ungrouped projection), and its logits lie within 1e-5 of the default
    route's, which on the CPU runs the kernels' plain versions."""
    cfg, params, statics, batch, kw = _kernel_route_model(arch)
    calls = []
    for name in ("flash_attention", "pattern_spmm_raw"):
        real = getattr(ops, name)

        def counting(*a, name=name, real=real, **k):
            calls.append(name)
            return real(*a, **k)

        monkeypatch.setattr(ops, name, counting)
    # layers holds its own reference to the spmm op
    monkeypatch.setattr(tl, "pattern_spmm_raw", ops.pattern_spmm_raw)
    extra = kw(batch) if kw else {}
    with torch.no_grad():
        want, _, _ = apply_model(params, statics, batch["tokens"], **extra)
        assert calls
        calls.clear()
        got, _, _ = apply_model(params, statics, batch["tokens"],
                                kernels=False, **extra)
    assert calls == []
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1.0))
    assert rel <= 1e-5


def _refuse(name):
    def launch(*args, **kwargs):
        raise AssertionError(f"a training step reached {name}")
    return launch


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "whisper_small"])
def test_train_step_reaches_no_kernel_wrapper(monkeypatch, arch):
    """On the models of :func:`_kernel_route_model`, with every wrapper
    replaced by one that raises, the step completes, and its loss equals
    the same step's with the wrappers in place."""
    cfg, params, statics, batch, kw = _kernel_route_model(arch)
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=1)
    step = make_train_step(cfg, statics, opt, lambda s: 1e-3, tcfg, kw)
    _, want = step(init_train_state(params, opt, tcfg), batch)
    for mod, name in ((tk, "pattern_spmm_cuda"),
                      (tk, "pattern_spmm_quant_cuda"),
                      (tou, "ou_mvm_cuda"), (tfa, "flash_attention_cuda")):
        monkeypatch.setattr(mod, name, _refuse(name))
        monkeypatch.setattr(ops, name, _refuse(name))
    _, got = step(init_train_state(params, opt, tcfg), batch)
    assert float(got["loss"]) == float(want["loss"])
    assert np.isfinite(float(got["grad_norm"]))
