"""The donated train step (CPU).

The reference donates the train state where it jits its step
(``src/repro/launch/train.py``, ``src/repro/launch/steps.py``:
``donate_argnums=(0,)``); the port's ``runtime.train.make_train_step(...,
donate=True)`` gives the state up the same way, and the launcher and
``launch.steps.build_step`` build it so:

  * two steps of the donated step equal two of the functional one bit
    for bit (metrics and every leaf of the state, dtypes included), with
    float32 and bfloat16 AdamW moments, on one device and sharded on a
    2 x 2 ``(data, model)`` gloo mesh (``tests/torch_mesh_worker.py``'s
    ``donate`` job), int8 gradient compression and microbatches too;
  * after each call the caller's state, and every container of it the
    caller kept, holds no leaf; old leaves of another dtype (bfloat16
    moments, which come back float32) are freed;
  * ``launch.op_stats``' peak of a donated smoke step lies below the
    functional step's by the old state's bytes, within one leaf.
"""

import gc
import weakref

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import _static_tensors
from repro_torch.launch.op_stats import OpStats, fake_mode
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import _leaves, _map
from repro_torch.runtime import train as rt
from test_torch_sharded import _run_ranks

STEPS = 2
LR = 1e-3
TOKENS = (8, 17)
ARCHS = ("granite_3_2b", "jamba_1_5_large_398b")
MOMENTS = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 3) -> dict:
    return {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, TOKENS))}


def _run(cfg, donate: bool, mu: str, **tkw):
    """``STEPS`` steps from seed 0's params: (metrics, final state)."""
    statics = ttr.init_statics(cfg, "cpu")
    params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    opt = adamw(mu_dtype=getattr(torch, mu))
    tcfg = rt.TrainConfig(steps=STEPS, **tkw)
    step = rt.make_train_step(cfg, statics, opt, lambda s: LR, tcfg,
                              donate=donate)
    state = rt.init_train_state(params, opt, tcfg)
    del params
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, _batch(cfg))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, state


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("mu", MOMENTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_donated_step_equals_functional(arch, mu):
    cfg = get_smoke_config(arch)
    want, want_state = _run(cfg, False, mu)
    got, got_state = _run(cfg, True, mu)
    assert got == want
    assert _equal(got_state, want_state)
    # bfloat16 moments come back float32, as the reference's do
    assert {t.dtype for t in _leaves(got_state["opt_state"]["mu"])} == {
        torch.float32}


def test_donated_step_with_compression_and_microbatches():
    cfg = get_smoke_config("granite_3_2b")
    for tkw in ({"grad_compression": True}, {"microbatches": 2}):
        want, want_state = _run(cfg, False, "float32", **tkw)
        got, got_state = _run(cfg, True, "float32", **tkw)
        assert got == want, tkw
        assert _equal(got_state, want_state), tkw


@pytest.mark.parametrize("mu", MOMENTS)
def test_caller_state_holds_no_old_leaf(mu):
    cfg = get_smoke_config("granite_3_2b")
    statics = ttr.init_statics(cfg, "cpu")
    params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    opt = adamw(mu_dtype=getattr(torch, mu))
    tcfg = rt.TrainConfig()
    step = rt.make_train_step(cfg, statics, opt, lambda s: LR, tcfg,
                              donate=True)
    state = rt.init_train_state(params, opt, tcfg)
    del params
    kept = {"params": state["params"], "opt_state": state["opt_state"],
            "body": state["params"]["body"]}
    moments = [weakref.ref(t) for t in _leaves(state["opt_state"]["mu"])]
    new, _ = step(state, _batch(cfg))
    gc.collect()
    assert state == {}
    assert kept["params"] == {} and kept["opt_state"] == {}
    assert kept["body"] == []
    new_ids = {id(t) for t in _leaves(new)}
    alive = [r() for r in moments if r() is not None]
    # a float32 moment is written in place (the new state's leaf); a
    # bfloat16 one is freed once its float32 successor is written
    assert all(id(t) in new_ids for t in alive)
    assert (len(alive) == 0) == (mu == "bfloat16")


def test_donated_peak_falls_by_the_state():
    """On fake tensors: the functional step's peak holds the old state
    beside the new one, the donated step's does not (a batch of 2 x 16
    tokens, whose activations stay below the update's bytes)."""
    cfg = get_smoke_config("h2o_danube_1_8b")
    statics = ttr.init_statics(cfg, "cpu")
    peaks = {}
    for donate in (False, True):
        opt = adamw()
        tcfg = rt.TrainConfig()
        step = rt.make_train_step(cfg, statics, opt, lambda s: LR, tcfg,
                                  donate=donate)
        with fake_mode():
            params, _ = ttr.init_params(cfg, torch.Generator(),
                                        device="cpu")
            state = rt.init_train_state(params, opt, tcfg)
            del params
            old = sum(t.numel() * t.element_size() for t in _leaves(state))
            largest = max(t.numel() * t.element_size()
                          for t in _leaves(state))
            tokens = torch.zeros((2, 17), dtype=torch.long)
            with OpStats() as st:
                st.add_inputs(state, {"tokens": tokens},
                              _static_tensors(statics))
                state, _ = step(state, {"tokens": tokens})
        peaks[donate] = st.peak_bytes
    fall = peaks[False] - peaks[True]
    assert abs(fall - old) <= largest, (peaks, old, largest)


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    """The ``donate`` job on a 2 x 2 mesh: jamba (MoE, SSM) with float32
    and bfloat16 moments, granite with int8 compression and with 2
    microbatches."""
    cases = []
    for name, arch, tkw, mu in (
            ("jamba_f32", "jamba_1_5_large_398b", {}, "float32"),
            ("jamba_bf16", "jamba_1_5_large_398b", {}, "bfloat16"),
            ("granite_compression", "granite_3_2b",
             {"grad_compression": True}, "float32"),
            ("granite_microbatches", "granite_3_2b", {"microbatches": 2},
             "float32")):
        cfg = get_smoke_config(arch)
        params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        batch = {"tokens": _batch(cfg)["tokens"].numpy()}
        cases.append((name, cfg, _map(lambda t: t.numpy(), params), batch,
                      tkw, mu))
    ranks = _run_ranks(tmp_path_factory.mktemp("donate"), 4, [{
        "name": "donate", "kind": "donate", "mesh": (2, 2), "steps": STEPS,
        "lr": LR, "cases": cases}])
    return [r["donate"] for r in ranks]


@pytest.mark.parametrize("name", ["jamba_f32", "jamba_bf16",
                                  "granite_compression",
                                  "granite_microbatches"])
def test_sharded_donated_step_equals_functional(sharded_world, name):
    """On 2 x 2 (ZeRO-1 moment slabs, each param slab dropped once its
    moment slab is cut): every rank's metrics and the whole state equal
    the functional step's bit for bit, and each call leaves the caller's
    state empty."""
    for r in sharded_world:
        want, got = r[name, False], r[name, True]
        assert got["metrics"] == want["metrics"]
        assert all(got["emptied"]) and not any(want["emptied"])
    want, got = sharded_world[0][name, False], sharded_world[0][name, True]
    assert want["state"].keys() == got["state"].keys()
    for key, value in want["state"].items():
        assert got["state"][key].dtype == value.dtype, key
        assert got["state"][key].tobytes() == value.tobytes(), key
