"""``launch.op_stats.OpStats`` on fake tensors, the twins of
``tests/test_hlo_stats.py``'s known programs (CPU).

  * a plain matmul counts exactly 2·64·128·256 FLOPs; a Python loop of 10
    counts ten times that (each iteration dispatches its ops, so no trip
    count is recovered); nested loops of 4 x 5, twenty times;
  * the gradient with respect to ``w`` alone counts between 2x and 3x
    the forward product; a registered 4 MB input counts at least 4 MB;
  * the peak of live bytes of two small programs equals the hand count;
  * collectives over a 4 x 4 fake mesh count by kind, bytes (an
    all-gather's whole output) and mesh dim;
  * a kernel wrapper handed a fake tensor raises.
"""

import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch.op_stats import OpStats, fake_mode

MB = 1 << 20


def _stats(fn, *shapes, grad=()):
    """``fn`` over zeros of ``shapes`` (``grad``: the indices that require
    grad), all fake, under a fresh ``OpStats``."""
    with fake_mode():
        args = [torch.zeros(s, requires_grad=i in grad)
                for i, s in enumerate(shapes)]
        with OpStats() as st:
            fn(*args)
    return st


def test_plain_matmul_flops():
    st = _stats(lambda a, b: a @ b, (64, 128), (128, 256))
    assert st.flops == 2 * 64 * 128 * 256


def test_python_loop_counts_every_iteration():
    def f(x, ws):
        for i in range(10):
            x = x @ ws[i]
        return x

    st = _stats(f, (128, 256), (10, 256, 256))
    assert st.flops == 2 * 128 * 256 * 256 * 10


def test_nested_loops():
    def g(x, ws):
        for i in range(4):
            for _ in range(5):
                x = x @ ws[i]
        return x

    st = _stats(g, (128, 256), (4, 256, 256))
    assert st.flops == 2 * 128 * 256 * 256 * 20


def test_grad_counts_forward_and_backward():
    def grad(w, x):
        loss = ((x @ w) ** 2).sum()
        return torch.autograd.grad(loss, [w])

    st = _stats(grad, (128, 256), (64, 128), grad=(0,))
    one = 2 * 64 * 128 * 256
    assert 2 * one <= st.flops <= 3 * one


def test_inputs_counted_in_bytes():
    with fake_mode():
        x = torch.zeros(1024, 1024)  # 4 MB float32
        with OpStats() as st:
            st.add_inputs(x)
            x * 2.0
    assert st.bytes >= 4 * MB


def test_peak_of_a_chain_frees_what_it_drops():
    """a, then b = a + 1 with a dropped, then c = b + 1 with b dropped,
    then d = c + 1: never more than two buffers of 1 MB live; the input
    counts from the start."""
    with fake_mode():
        x = torch.empty(MB, dtype=torch.uint8)
        with OpStats() as st:
            st.add_inputs(x)
            a = x + 1
            b = a + 1
            del a
            c = b + 1
            del b
            d = c + 1  # noqa: F841
    assert st.peak_bytes == 3 * MB
    assert st.live_bytes == 3 * MB


def test_peak_counts_what_autograd_saves():
    """y = tanh(x @ w) saves its output for the backward, and the product
    (which nothing saves) is freed once tanh has run.  At the peak, at
    the end of the backward: the inputs w (256 KB) and x (64 KB), y
    (64 KB), the sum and its gradient (4 B each; y's gradient is the
    latter expanded, no storage of its own), the product's gradient
    (64 KB) and w's (256 KB)."""
    k = 1024
    with fake_mode():
        w = torch.empty(256, 256, requires_grad=True)
        x = torch.empty(64, 256)
        with OpStats() as st:
            st.add_inputs(w, x)
            y = torch.tanh(x @ w)
            (g,) = torch.autograd.grad(y.sum(), [w])
    assert st.peak_bytes == (256 + 64) * k + (64 + 64 + 256) * k + 8


COLLECTIVES = """
import json, torch, torch.distributed as dist
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.op_stats import OpStats, fake_mode
from repro_torch.parallel.tensor import TensorParallel
mesh = make_fake_mesh((4, 4), ("data", "model"))
tp = TensorParallel(mesh, 4, 0, mesh.get_group("model"))
with fake_mode():
    x = torch.empty(8, 32)
    with OpStats().name_groups(mesh) as st:
        dist.all_reduce(x, group=mesh.get_group("model"))
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x, group=mesh.get_group("data"))
        out = torch.empty(8, 32)
        dist.all_to_all_single(out, x, group=mesh.get_group("model"))
        # a stream [2, 8, 16] reduce-scattered along the sequence, then
        # its slab [2, 2, 16] gathered back
        tp.gather_seq(tp.scatter_seq(torch.empty(2, 8, 16)))
print(json.dumps({"counts": dict(st.collective_counts),
                  "bytes": dict(st.collective_bytes_by_kind),
                  "by_dim": dict(st.collective_bytes_by_dim),
                  "total": st.collective_bytes,
                  "tp": [tp.scatter_bytes, tp.seq_gather_bytes]}))
"""


def test_collectives_on_a_fake_mesh():
    """One all-reduce over ``model`` (its 1 KB), one all-gather over
    ``data`` (the 4 KB it assembles), one all-to-all over ``model``, and
    the sequence's reduce-scatter (its 256-byte slab) and all-gather (the
    1 KB it assembles) over ``model``; in a
    process of its own, as the fake group is the process's default."""
    import json
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["counts"] == {"all-reduce": 1, "all-gather": 2,
                             "all-to-all": 1, "reduce-scatter": 1}
    assert res["bytes"] == {"all-reduce": 1024.0, "all-gather": 5120.0,
                            "all-to-all": 1024.0, "reduce-scatter": 256.0}
    assert res["by_dim"] == {"all-reduce/model": 1024.0,
                             "all-gather/data": 4096.0,
                             "all-to-all/model": 1024.0,
                             "reduce-scatter/model": 256.0,
                             "all-gather/model": 1024.0}
    assert res["total"] == 7424.0
    # what the sharded step's step.comm reads of them
    assert res["tp"] == [256, 1024]


@pytest.mark.parametrize("wrapper", ["flash", "spmm", "ou_mvm"])
def test_kernel_wrappers_refuse_fake_tensors(wrapper):
    """On the CPU a wrapper would take its plain version; handed a fake
    tensor it raises instead of standing in quietly."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ou_mvm import ou_mvm_cuda
    from repro_torch.kernels.pattern_spmm import pattern_spmm_cuda

    with fake_mode():
        if wrapper == "flash":
            q = torch.empty(1, 2, 8, 16)
            call = lambda: flash_attention_cuda(q, q, q)  # noqa: E731
        elif wrapper == "spmm":
            call = lambda: pattern_spmm_cuda(  # noqa: E731
                torch.empty(4, 8), torch.empty(1, 1, 8, 8),
                torch.zeros(1, 1, dtype=torch.int32), None, 8)
        else:
            call = lambda: ou_mvm_cuda(torch.empty(4, 18),  # noqa: E731
                                       torch.empty(18, 8))
        with pytest.raises(ValueError, match="fake tensor"):
            call()
