"""The sequence-split residual stream of the port's sharded train step
(CPU).

Inside ``parallel.tensor.tensor_parallel_ctx`` the stream between layers
is each ``model`` rank's slab of the sequence where the rank count
divides it, as the reference's ``("batch", "seq_shard", None)``
constraint splits it.  On two spawned ``gloo`` ranks
(``tests/torch_mesh_worker.py``'s ``tp_blocks`` job, its ``seq_*``
cases):

  * ``gather_sequence`` (its reduce-scatter backward and its ``whole``
    slice backward), ``scatter_sequence`` and ``split_sequence`` give the
    whole tensor's forward and backward within 1e-6, and count the bytes
    they move;
  * an RMSNorm run on the slabs with its scale entering by
    ``transformer._on_slab`` gives the whole norm's output slab and, its
    gradient summed over the ranks, the whole scale's gradient (each rank
    alone holds its tokens' share);
  * ``apply_model`` checkpoints each period's input as the rank's slab
    ``[B, S / n, d]`` where ``n`` divides ``S``, and whole where it does
    not (15 positions over 2); whisper's 24 frames split the encoder's
    stream while its decoder's 15 positions stay whole.

The grid of whole train steps on split streams is in
``tests/test_torch_tensor_parallel.py``.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import rmsnorm
from repro_torch.optim.optimizers import _map
from repro_torch.parallel import activations, tensor
from test_torch_sharded import _run_ranks

TOL = 1e-6
N = 2
B, S, D = 3, 8, 6


def _numpy(tree):
    return _map(lambda t: t.numpy(), tree)


def _stream_case(arch, seq):
    cfg = get_smoke_config(arch)
    params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(17)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, seq))}
    if cfg.encoder_layers:
        inputs["frames"] = rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return (f"stream_{arch}_{seq}", "seq_stream", cfg, _numpy(params),
            inputs)


def _cases():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    dy = rng.normal(size=(B, S, D)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    return [("fns", "seq_fns", None, {}, {"x": x, "dy": dy}),
            ("norm", "seq_norm", None, {"scale": scale}, {"x": x, "dy": dy}),
            _stream_case("granite_3_2b", 16), _stream_case("granite_3_2b", 15),
            _stream_case("whisper_small", 15)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the ``seq_*`` cases."""
    cases = _cases()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = _run_ranks(tmp_path_factory.mktemp("seq"), N, [
            {"name": "seq", "kind": "tp_blocks", "mesh": (1, N),
             "cases": cases}])
    finally:
        torch.set_num_threads(n)
    return {c[0]: c for c in cases}, [r["seq"] for r in ranks]


def _close(got, want, what):
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _slab(t, r):
    w = t.shape[1] // N
    return t[:, r * w:(r + 1) * w]


@pytest.mark.parametrize("fn", ["gather", "gather_whole", "scatter",
                                "split"])
def test_functions_give_the_whole_tensor(fn, world):
    """Rank r's input is its slab of ``x`` (``scatter``: the whole ``x``
    times r + 1; ``split``: the whole ``x``) and its upstream gradient
    ``dy`` times r + 1 (its slab where the output is one)."""
    cases, ranks = world
    x, dy = cases["fns"][4]["x"], cases["fns"][4]["dy"]
    total = sum(r + 1 for r in range(N))
    for r, got in enumerate(ranks):
        got = got["fns"][fn]
        mine = dy * (r + 1)
        if fn == "gather":  # the ranks' parts summed, this rank's slab
            want_y, want_dx = x, _slab(dy * total, r)
        elif fn == "gather_whole":  # this rank's slice of its own gradient
            want_y, want_dx = x, _slab(mine, r)
        elif fn == "scatter":  # the sum's slab; the slabs' gradients gathered
            want_y = _slab(x * total, r)
            want_dx = np.concatenate([_slab(dy * (q + 1), q)
                                      for q in range(N)], axis=1)
        else:
            want_y = _slab(x, r)
            want_dx = np.concatenate([_slab(dy * (q + 1), q)
                                      for q in range(N)], axis=1)
        _close(got["y"], want_y, (fn, "y"))
        _close(got["dx"], want_dx, (fn, "dx"))
        whole, slab = B * S * D * 4, B * S // N * D * 4
        assert (got["gather_bytes"], got["scatter_bytes"]) == {
            "gather": (whole, slab), "gather_whole": (whole, 0),
            "scatter": (whole, slab), "split": (whole, 0)}[fn]


def test_norm_weight_gradient_sums_over_the_slabs(world):
    """Each rank's scale gradient is the whole one (its tokens' share
    summed over the ranks in float32), its output the whole norm's slab;
    the sum moved ``D`` float32 values."""
    cases, ranks = world
    _, _, _, params, inputs = cases["norm"]
    scale = torch.tensor(params["scale"], requires_grad=True)
    y = rmsnorm({"scale": scale}, torch.as_tensor(inputs["x"]))
    (y * torch.as_tensor(inputs["dy"])).sum().backward()
    for r, got in enumerate(ranks):
        got = got["norm"]
        _close(got["y"], _slab(y.detach().numpy(), r), "y")
        _close(got["dscale"], scale.grad.numpy(), "dscale")
        assert got["reduce_bytes"] == D * 4
    # a rank's own share is not the whole gradient
    half = torch.tensor(params["scale"], requires_grad=True)
    x0 = _slab(torch.as_tensor(inputs["x"]), 0)
    (rmsnorm({"scale": half}, x0)
     * _slab(torch.as_tensor(inputs["dy"]), 0)).sum().backward()
    assert float((half.grad - scale.grad).abs().max()) > 1e-3


@pytest.mark.parametrize("case,periods,enc", [
    ("stream_granite_3_2b_16", (8,), ()),
    ("stream_granite_3_2b_15", (15,), ()),
    ("stream_whisper_small_15", (15,), (12,))])
def test_checkpointed_stream_is_the_slab(case, periods, enc, world):
    """Each remat checkpoint's input: ``[2, S / 2, d]`` where 2 divides
    the stream's length, whole where it does not; the encoder's first
    (its layers run before the decoder's)."""
    cases, ranks = world
    cfg = cases[case][2]
    statics = ttr.init_statics(cfg, "cpu")
    want = ([(2, e, cfg.d_model) for e in enc] * cfg.encoder_layers
            + [(2, p, cfg.d_model) for p in periods] * statics["n_periods"])
    seq = cases[case][4]["tokens"].shape[1]
    for got in ranks:
        assert got[case]["shapes"] == want
        assert got[case]["logits"] == (2, seq, cfg.padded_vocab // N)


def test_a_sequence_that_does_not_divide_stays_whole():
    """``shard_activation`` returns the rank's slab inside a context
    whose ``model`` size divides the sequence, ``x`` itself elsewhere
    (no collective runs in the forward of either)."""
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    spec = ("batch", "seq_shard", None)
    assert activations.shard_activation(x, spec) is x
    for size, rank, seq, want in ((2, 1, 6, x[:, 3:]), (3, 2, 6, x[:, 4:]),
                                  (4, 1, 6, x), (1, 0, 6, x)):
        with tensor.entered(tensor.TensorParallel(None, size, rank, None)):
            got = activations.shard_activation(x[:, :seq], spec)
        assert torch.equal(got, want)
    assert tensor.seq_splits(16, 4352) and not tensor.seq_splits(16, 1500)
