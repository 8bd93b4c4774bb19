"""Remat in the port's ``apply_model`` (CPU, smoke configs).

``ModelConfig.remat`` (default True, as the reference's) runs each
period of the body and each encoder layer under a non-reentrant
``torch.utils.checkpoint`` where autograd records the forward, there is
no cache and no placed serving state (``models.transformer._remat``):

  * for every entry of ``ARCH_NAMES`` (whisper's encoder, DeepSeek-V3's
    MTP head, paligemma's prefix included), the loss and every gradient
    with remat equal those without it bit for bit, and the body's and
    the encoder's layers run twice (the recompute), the prefix and MTP
    layers once;
  * without grad, or with a cache, every layer runs once;
  * the recompute sees the forward's ``parallel.tensor`` context even
    when the backward runs on another thread;
  * on rank 0's slabs of a two-rank ``model`` group whose all-reduces
    and reduce-scatters are recorded (nothing moves), the recomputes
    all-reduce and reduce-scatter what the forward did less each period's
    (and encoder layer's) trailing collective, which torch's early stop
    skips: ``parallel.tensor._trailing``, which ``model_bytes`` subtracts
    (a torch whose early stop stops elsewhere fails here first); the
    decoder's 17 positions keep its stream whole, whisper's 24 frames
    split the encoder's over the sequence;
  * on an 8-layer granite, ``launch.op_stats`` counts a lower peak and
    more FLOPs (the recomputed forward) with remat than without.

The sharded step's remat (bit-equal on the 1 x 2 and 2 x 2 grids, the
bytes over ``model`` that ``parallel.tensor.model_bytes`` reckons) is in
``tests/test_torch_tensor_parallel.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.launch.op_stats import OpStats
from repro_torch.launch.steps import param_shardings
from repro_torch.models import transformer as ttr
from repro_torch.optim.optimizers import _leaves, _map
from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import shard_tensor
from repro_torch.runtime import train as ttrain

ROWS, SEQ = 2, 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    """A seeded batch ``[ROWS, SEQ + 1]`` and ``apply_model``'s extra
    inputs."""
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (ROWS, SEQ + 1)))
    kw = {}
    if cfg.encoder_layers:
        kw["frames"] = torch.as_tensor(rng.normal(
            size=(ROWS, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.prefix_len:
        kw["prefix_embeds"] = torch.as_tensor(rng.normal(
            size=(ROWS, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    return tokens, kw


def _loss_and_grads(cfg, params, statics, tokens, kw):
    """The train step's loss (the MTP term included) and its gradient
    for every param leaf."""
    leaves = _leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    tree = _map(lambda _: next(it), params)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _, aux = ttr.apply_model(tree, statics, inputs, kernels=False,
                                     **kw)
    loss = ttrain.cross_entropy(logits[:, -labels.shape[1]:], labels,
                                cfg.vocab)
    if "mtp_logits" in aux:
        loss = loss + 0.3 * ttrain.cross_entropy(
            aux["mtp_logits"], torch.roll(labels, -1, dims=1), cfg.vocab)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), grads


def _counting(monkeypatch):
    """Count ``_apply_layer``'s calls (forward and recompute)."""
    calls = []
    real = ttr._apply_layer

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttr, "_apply_layer", spy)
    return calls


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_is_bit_equal(arch, monkeypatch):
    calls = _counting(monkeypatch)
    cfg = get_smoke_config(arch)
    assert cfg.remat
    params, statics = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens, kw = _inputs(cfg)
    out, counts = {}, {}
    for remat in (True, False):
        calls.clear()
        st = dict(statics, cfg=dataclasses.replace(cfg, remat=remat))
        out[remat] = _loss_and_grads(st["cfg"], params, st, tokens, kw)
        counts[remat] = len(calls)
    (loss, grads), (want_loss, want_grads) = out[True], out[False]
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    twice = (statics["n_periods"] * statics["period"]
             + cfg.encoder_layers)
    once = statics["prefix"] + cfg.mtp
    assert twice > 0
    assert counts == {True: 2 * twice + once, False: twice + once}


def test_remat_only_where_a_step_records_grads(monkeypatch):
    """No grad, or a cache (a serving prefill), runs each layer once."""
    calls = _counting(monkeypatch)
    cfg = get_smoke_config("granite_3_2b")
    params, statics = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens, _ = _inputs(cfg)
    with torch.no_grad():
        ttr.apply_model(params, statics, tokens, kernels=False)
    assert len(calls) == cfg.n_layers
    calls.clear()
    cache = ttr.init_cache(statics, ROWS, 64, torch.float32)
    live = _map(lambda p: p.detach().requires_grad_(True), params)
    logits, _, _ = ttr.apply_model(live, statics, tokens, cache=cache,
                                   cache_pos=torch.tensor(0),
                                   kernels=False)
    logits.float().sum().backward()
    assert len(calls) == cfg.n_layers


def test_recompute_sees_the_forwards_tensor_parallel_context():
    """The forward runs inside a ``parallel.tensor`` context and the
    backward on a thread that never entered it: the recompute sees the
    forward's context all the same."""
    seen = []
    marker = object()

    def fn(x):
        seen.append(tensor.current())
        return torch.sin(x * x)

    x = torch.randn(8, requires_grad=True)
    with tensor.entered(marker):
        y = ttr._remat(fn, x)
    worker = threading.Thread(target=lambda: y.sum().backward())
    worker.start()
    worker.join()
    assert seen == [marker, marker]
    assert torch.equal(x.grad, torch.cos(x * x) * 2 * x)


@dataclasses.dataclass
class _Recorded(tensor.TensorParallel):
    """Rank 0 of a two-rank ``model`` group that moves nothing and
    records each all-reduce and reduce-scatter: (kind, inside a remat
    period's function, bytes).  The backward's own collectives run
    outside it."""

    calls: list = dataclasses.field(default_factory=list)
    inside: list = dataclasses.field(default_factory=list)

    def all_reduce(self, t, op=None):
        out = t.float().contiguous().clone()
        self.calls.append(("reduce", bool(self.inside), 4 * out.numel()))
        return out.to(t.dtype)

    def all_gather(self, t):
        return torch.cat([t] * self.size, dim=-1)

    def gather_seq(self, t):
        return torch.cat([t] * self.size, dim=1)

    def scatter_seq(self, t):
        out = t.float()[:, :t.shape[1] // self.size].contiguous()
        self.calls.append(("scatter", bool(self.inside), 4 * out.numel()))
        return out.to(t.dtype)


class _RankZero:
    """What the placements read of a ``DeviceMesh``: rank 0 of
    ``model`` = 2."""

    mesh_dim_names, shape = ("model",), (2,)

    def get_local_rank(self, dim):
        return 0


@pytest.mark.parametrize("arch", ["granite_3_2b", "whisper_small"])
def test_recompute_skips_only_the_trailing_reduce(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    params, statics = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens, kw = _inputs(cfg)
    tp = _Recorded(None, 2, 0, None)
    real = ttr._remat

    def marked(fn, *args):
        def run(*a):
            tp.inside.append(1)
            try:
                return fn(*a)
            finally:
                tp.inside.pop()
        return real(run, *args)

    monkeypatch.setattr(ttr, "_remat", marked)
    on_slab = tensor.slab_leaves(cfg, statics, params, 2)
    slabs = _map(lambda t, pl, on: shard_tensor(t, pl) if on else t, params,
                 param_shardings(ttr.init_specs(cfg), params, _RankZero()),
                 on_slab)
    live = _map(lambda p: p.detach().requires_grad_(True), slabs)
    with tensor.entered(tp):
        logits, _, _ = ttr.apply_model(live, statics, tokens[:, :-1],
                                       kernels=False, **kw)
        seen = len(tp.calls)
        logits.float().square().sum().backward()
    dec = ROWS * (SEQ + cfg.prefix_len)
    trailing = {k: statics["n_periods"] * v for k, v in tensor._trailing(
        cfg, statics["body"][-1], 2, dec,
        tensor.seq_splits(2, SEQ + cfg.prefix_len)).items()}
    if cfg.encoder_layers:
        for k, v in tensor._trailing(
                cfg, statics["encoder"], 2, ROWS * cfg.enc_seq,
                tensor.seq_splits(2, cfg.enc_seq)).items():
            trailing[k] += cfg.encoder_layers * v
    assert sum(trailing.values()) > 0
    for kind in ("reduce", "scatter"):
        forward = sum(n for k, inside, n in tp.calls[:seen]
                      if inside and k == kind)
        recomputed = sum(n for k, inside, n in tp.calls[seen:]
                         if inside and k == kind)
        assert forward >= trailing[kind]
        assert recomputed == forward - trailing[kind], kind
    assert sum(n for _, inside, n in tp.calls[:seen] if inside) > sum(
        trailing.values())


def test_remat_lowers_the_counted_peak():
    """On real tensors, ``OpStats`` over the loss and its gradient: the
    peak falls and the FLOPs grow by the recomputed forward."""
    base = get_smoke_config("granite_3_2b")
    cfg = dataclasses.replace(base, n_layers=8,
                              layer_types=base.layer_types[:1] * 8)
    params, statics = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens, _ = _inputs(cfg)
    stats = {}
    for remat in (True, False):
        st = dict(statics, cfg=dataclasses.replace(cfg, remat=remat))
        with OpStats() as counted:
            counted.add_inputs(params, tokens)
            _loss_and_grads(st["cfg"], params, st, tokens, {})
        stats[remat] = counted
    assert stats[True].peak_bytes < stats[False].peak_bytes
    assert stats[True].flops > stats[False].flops
