"""The port's fault-tolerance policies and token data pipeline against the
JAX reference (CPU).

``runtime/fault.py`` and ``data/pipeline.py`` are host numpy copied from
the reference, so the same calls must give the same results: the same
flags, delays and failures, and batches equal bit for bit (a seeded
bigram corpus, and token files of both widths that the tests write,
across an epoch boundary).  ``shard_batch`` keeps a rank's rows of a
``DeviceMesh``: on a one-rank mesh here, and on a spawned two-rank gloo
group (``tests/torch_mesh_worker.py``'s ``data`` job), which also runs
``error_feedback_allreduce`` across the two ranks.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data import pipeline as jdata
from repro.runtime import fault as jfault

from repro_torch.data import (
    DataConfig,
    SyntheticCorpus,
    TokenFileDataset,
    packed_batches,
    shard_batch,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import compress_gradients, decompress_gradients
from repro_torch.optim import init_compression_state
from repro_torch.runtime import fault as tfault
from test_torch_sharded import _run_ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- fault


@pytest.mark.parametrize("window,threshold", [(50, 2.0), (8, 1.5)])
def test_straggler_flags_equal_reference(window, threshold):
    times = np.random.default_rng(4).lognormal(-2.0, 0.6, 200).tolist()
    j = jfault.StragglerDetector(window=window, threshold=threshold)
    t = tfault.StragglerDetector(window=window, threshold=threshold)
    assert ([t.record(i, d) for i, d in enumerate(times)]
            == [j.record(i, d) for i, d in enumerate(times)])
    assert t.flagged == j.flagged and list(t.times) == list(j.times)


def test_heartbeat_monitor_equals_reference():
    hosts = [f"h{i}" for i in range(5)]
    j = jfault.HeartbeatMonitor(hosts, timeout=10.0)
    t = tfault.HeartbeatMonitor(hosts, timeout=10.0)
    # every host beats at a given time first: the constructor stamps the
    # monotonic clock, which differs between the two monitors
    calls = [(h, 90.0) for h in hosts] + [
        ("h0", 100.0), ("h1", 103.0), ("h3", 95.0), ("h0", 111.0),
        ("h4", 89.0)]
    for mon in (j, t):
        for h, at in calls:
            mon.beat(h, at)
    for now in (100.0, 105.5, 113.0, 121.0, 130.0):
        assert t.dead_hosts(now) == j.dead_hosts(now)
    assert t.last_seen == j.last_seen
    # an unknown host joins on its first beat
    for mon in (j, t):
        mon.beat("h9", 125.0)
    assert t.dead_hosts(140.0) == j.dead_hosts(140.0)


@pytest.mark.parametrize("kw", [{}, dict(max_restarts=4, backoff_base=0.5,
                                         backoff_cap=3.0)])
def test_restart_policy_equals_reference(kw):
    j, t = jfault.RestartPolicy(**kw), tfault.RestartPolicy(**kw)
    seq_j = [j.next_delay() for _ in range(14)]
    seq_t = [t.next_delay() for _ in range(14)]
    assert seq_t == seq_j and seq_t[-1] is None
    assert t.restarts == j.restarts


def test_failure_injector_equals_reference():
    schedule = {3: "node-failure", 7: "crash-after-save", 9: ""}

    def drive(mod):
        inj = mod.FailureInjector(schedule)
        out = []
        for step in [0, 3, 3, 5, 7, 9, 7, 10]:
            try:
                inj.maybe_fail(step)
                out.append(None)
            except mod.SimulatedFailure as e:
                out.append(str(e))
        return out, inj.fired

    assert drive(tfault) == drive(jfault)
    assert issubclass(tfault.SimulatedFailure, RuntimeError)


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 3])
def test_packed_batches_bit_equal(seed):
    tcfg = DataConfig(vocab=515, seq_len=32, global_batch=8, seed=seed)
    jcfg = jdata.DataConfig(vocab=515, seq_len=32, global_batch=8, seed=seed)
    tb, jb = packed_batches(tcfg), jdata.packed_batches(jcfg)
    for _ in range(6):
        got, want = next(tb)["tokens"], next(jb)["tokens"]
        assert got.dtype == want.dtype
        assert got.shape == (8, 33)
        np.testing.assert_array_equal(got, want)


def test_bigram_entropy_equal():
    for vocab, seed in ((515, 0), (64, 3)):
        t = SyntheticCorpus(vocab, seed)
        j = jdata.SyntheticCorpus(vocab, seed)
        np.testing.assert_array_equal(t.probs, j.probs)
        assert t.bigram_entropy() == j.bigram_entropy()


@pytest.mark.parametrize("dtype,hi", [(np.uint16, 60_000),
                                      (np.uint32, 3_000_000)])
def test_token_file_dataset_bit_equal(tmp_path, dtype, hi):
    """EOS-delimited documents (some empty) in a file of ``dtype``; 6
    batches of 4 x 33 tokens read the 300-token file about three times
    over, so the packing crosses epochs (each a new document order)."""
    rng = np.random.default_rng(2)
    toks = rng.integers(1, hi, 300).astype(dtype)
    toks[rng.choice(300, 25, replace=False)] = 0
    toks[[10, 11]] = 0  # an empty document
    path = tmp_path / "tokens.bin"
    toks.tofile(path)
    t = TokenFileDataset(str(path), dtype=dtype)
    j = jdata.TokenFileDataset(str(path), dtype=dtype)
    assert len(t) == len(j) == 300
    for seed in (0, 1):
        got, want = list(t.documents(seed)), list(j.documents(seed))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    cfg = DataConfig(vocab=hi, seq_len=32, global_batch=4, seed=1)
    jcfg = jdata.DataConfig(vocab=hi, seq_len=32, global_batch=4, seed=1)
    tb, jb = packed_batches(cfg, t), jdata.packed_batches(jcfg, j)
    for _ in range(6):
        np.testing.assert_array_equal(next(tb)["tokens"], next(jb)["tokens"])


def test_shard_batch_one_rank_mesh():
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    batch = next(packed_batches(DataConfig(vocab=515, seq_len=16,
                                           global_batch=4)))
    batch["frames"] = np.random.default_rng(0).normal(
        size=(4, 3, 8)).astype(np.float32)
    out = shard_batch(batch, mesh)
    assert set(out) == {"tokens", "frames"}
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), batch[k])


def test_shard_batch_and_allreduce_two_ranks(tmp_path):
    """Rank r of a (data=2, model=1) group keeps rows [4r, 4r + 4) of 8;
    ``error_feedback_allreduce`` of each rank's own gradients is the mean
    of their dequantized trees, and each rank keeps its own residual."""
    batch = next(packed_batches(DataConfig(vocab=515, seq_len=16,
                                           global_batch=8)))
    rng = np.random.default_rng(9)
    grads = {"w": rng.normal(size=(2, 6, 5)).astype(np.float32) * 1e-2,
             "b": rng.normal(size=(2, 7)).astype(np.float32)}
    job = {"name": "data", "kind": "data", "mesh": (2, 1), "batch": batch,
           "grads": grads}
    res = _run_ranks(tmp_path, 2, [job])
    dequant, residual = [], []
    for r in range(2):
        g = {k: torch.as_tensor(v[r]) for k, v in grads.items()}
        comp, state = compress_gradients(g, init_compression_state(g))
        dequant.append(decompress_gradients(comp))
        residual.append(state)
    for r in range(2):
        out = res[r]["data"]
        np.testing.assert_array_equal(out["rows"]["tokens"],
                                      batch["tokens"][4 * r:4 * r + 4])
        for k in grads:
            want = ((dequant[0][k] + dequant[1][k]) / 2).numpy()
            np.testing.assert_array_equal(out["reduced"][k], want)
            np.testing.assert_array_equal(out["residual"][k],
                                          residual[r][k].numpy())
