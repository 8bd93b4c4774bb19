"""The port's checkpointer against the JAX reference (CPU).

``checkpoint/checkpointer.py`` keeps the reference's on-disk layout
(``step_%010d/leaf_%05d.npy`` numbered in JAX's flattening order, and
``manifest.json``), so a checkpoint written by either package restores
in the other bit for bit.  First the twins of ``tests/test_checkpoint.py``'s
six cases (the elastic one restores onto a tree of devices), then the
cross-package cases on a granite smoke train state with AdamW and the
compression residuals, one direction at a time, with equal manifests and
equal leaf files, and a bf16 leaf saved by the reference, compared as
uint16 (the reference cannot restore it itself: ``jnp`` refuses the
``V2`` array ``np.load`` gives back).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtr
from repro.optim import adamw as j_adamw
from repro.runtime import train as jtrain

from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpointer import _leaf_paths
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import train as ttrain
from test_torch_lm import _port_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": torch.tensor(3.5)},
        "list": [torch.ones((2,)), torch.zeros((3,))],
    }


def _leaves(tree):
    return [leaf for _, leaf in _leaf_paths(tree)]


# ------------------------------------------ twins of test_checkpoint.py


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    out = restore_checkpoint(str(tmp_path), 5, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_atomicity_partial_write_ignored(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    # simulate a crashed writer: a .tmp dir and a final dir missing manifest
    os.makedirs(tmp_path / "step_0000000002.tmp")
    os.makedirs(tmp_path / "step_0000000003")
    assert latest_step(str(tmp_path)) == 1


def test_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(tmp_path)
        if n.startswith("step_")
    )
    assert steps == [3, 4]


def test_async_checkpointer(tmp_path):
    """Async saves snapshot to the host when called: a leaf changed in
    place after ``save`` returns does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=3, async_save=True)
    tree = _tree()
    want = tree["a"].clone()
    for s in (1, 2, 3):
        ck.save(s, tree)
    tree["a"].add_(1.0)
    ck.wait()
    assert ck.latest_step() == 3
    out = ck.restore(3, tree)
    assert torch.equal(out["a"], want)
    ck.close()


def test_restore_onto_device_tree(tmp_path):
    """The elastic twin: the checkpoint holds whole arrays, and restore
    places each leaf on the device the caller's tree names (here the
    ``meta`` device for two leaves), else on the target leaf's."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    meta, cpu = torch.device("meta"), torch.device("cpu")
    devices = {"a": meta, "nested": {"b": cpu, "c": meta},
               "list": [cpu, cpu]}
    out = restore_checkpoint(str(tmp_path), 7, tree, devices=devices)
    assert out["a"].device == meta and out["nested"]["c"].device == meta
    assert out["a"].shape == (4, 8)
    assert all(t.device == cpu for t in (out["nested"]["b"], *out["list"]))
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])


def test_restore_shape_mismatch_raises(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    bad = dict(tree)
    bad["a"] = torch.zeros((5, 8))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, bad)
    bad = dict(tree, extra=torch.zeros(2))
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(tmp_path), 1, bad)


# ------------------------------------------------------- cross-package


def test_leaf_order_is_jax_flattening_order():
    """Dict keys sorted, list and tuple items by index, None and empty
    containers without leaves: the keys and their order equal the
    reference's ``tree_flatten_with_path``."""
    tree = {"b": [np.zeros(1), (np.ones(2), None)], "a": {"z": 1.0,
            "y": []}, "c": np.arange(3)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in flat]
    assert [k for k, _ in _leaf_paths(tree)] == want


@pytest.fixture(scope="module")
def states():
    """A granite smoke train state with AdamW and compression residuals,
    one step in, in each package from the same weights and batch:
    (reference state, port state)."""
    jcfg = j_smoke("granite_3_2b")
    params, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = jtrain.TrainConfig(steps=1, grad_compression=True)
    opt = j_adamw(weight_decay=0.0)
    step = jtrain.make_train_step(jcfg, jst, opt, lambda s: 1e-3, tcfg)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (4, 17))
    jstate, _ = jax.jit(step)(jtrain.init_train_state(params, opt, tcfg),
                              {"tokens": jnp.asarray(tokens, jnp.int32)})
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ttcfg = ttrain.TrainConfig(steps=1, grad_compression=True)
    topt = adamw(weight_decay=0.0)
    tstep = ttrain.make_train_step(_port_cfg(jcfg), ttr.init_statics(
        _port_cfg(jcfg), "cpu"), topt, lambda s: 1e-3, ttcfg)
    tstate, _ = tstep(ttrain.init_train_state(tp, topt, ttcfg),
                      {"tokens": torch.as_tensor(tokens)})
    return jstate, tstate


def _assert_bits_equal(jtree, ttree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = _leaf_paths(ttree)
    assert len(jflat) == len(tflat)
    for (path, a), (key, b) in zip(jflat, tflat):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_reference_saves_port_restores(tmp_path, states):
    jstate, tstate = states
    j_save(str(tmp_path), 1, jstate)
    out = restore_checkpoint(str(tmp_path), 1, tstate)
    assert out["step"].dtype == torch.int32 and out["step"].shape == ()
    assert int(out["step"]) == 1
    assert out["opt_state"]["count"].dtype == torch.int32
    _assert_bits_equal(jstate, out)


def test_port_saves_reference_restores(tmp_path, states):
    jstate, tstate = states
    save_checkpoint(str(tmp_path), 1, tstate)
    out = j_restore(str(tmp_path), 1, jstate)
    _assert_bits_equal(out, tstate)


def test_manifests_and_leaf_files_equal(tmp_path, states):
    """The same values saved by each package: equal ``manifest.json``
    (keys, file numbers, shapes, dtypes) and byte-equal leaf files."""
    jstate, _ = states
    tstate = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jstate)
    j_save(str(tmp_path / "ref"), 3, jstate)
    save_checkpoint(str(tmp_path / "port"), 3, tstate)
    d_ref = tmp_path / "ref" / "step_0000000003"
    d_port = tmp_path / "port" / "step_0000000003"
    with open(d_ref / "manifest.json") as f:
        m_ref = json.load(f)
    with open(d_port / "manifest.json") as f:
        m_port = json.load(f)
    assert m_port == m_ref
    assert [e["key"] for e in m_port["leaves"]][-1] == "step"
    for e in m_ref["leaves"]:
        assert ((d_ref / e["file"]).read_bytes()
                == (d_port / e["file"]).read_bytes()), e["key"]


def test_reference_bf16_leaf_restores_bit_equal(tmp_path):
    """A bf16 leaf the reference writes (``'<V2'`` payload, ``"bfloat16"``
    in the manifest) restores in the port with equal bits; the port's own
    bf16 save writes the same payload bytes and manifest."""
    w = jax.random.normal(jax.random.PRNGKey(1), (6, 5)).astype(jnp.bfloat16)
    tree = {"w": w, "s": jnp.float32(2.0)}
    j_save(str(tmp_path / "ref"), 2, tree)
    with open(tmp_path / "ref" / "step_0000000002" / "manifest.json") as f:
        m_ref = json.load(f)
    assert [e["dtype"] for e in m_ref["leaves"]] == ["float32", "bfloat16"]
    with pytest.raises(TypeError, match="V2"):  # the reference's own restore
        j_restore(str(tmp_path / "ref"), 2, tree)
    target = {"w": torch.zeros((6, 5), dtype=torch.bfloat16),
              "s": torch.tensor(0.0)}
    out = restore_checkpoint(str(tmp_path / "ref"), 2, target)
    assert out["w"].dtype == torch.bfloat16
    want = np.asarray(w).view(np.uint16)
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy()
                                  .view(np.uint16), want)
    save_checkpoint(str(tmp_path / "port"), 2, out)
    with open(tmp_path / "port" / "step_0000000002" / "manifest.json") as f:
        assert json.load(f) == m_ref
    got = np.load(tmp_path / "port" / "step_0000000002" / "leaf_00001.npy")
    ref = np.load(tmp_path / "ref" / "step_0000000002" / "leaf_00001.npy")
    assert got.tobytes() == ref.tobytes()
