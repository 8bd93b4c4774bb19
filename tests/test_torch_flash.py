"""Port's flash attention against the JAX reference, and on the card.

The same numpy inputs go through ``repro.kernels.ops.flash_attention``
(the Pallas kernel in interpret mode, and the XLA oracle) and the port's
``ops.flash_attention`` (on the CPU, the wrapper's plain version), over
``tests/test_kernels.py``'s sweep plus the generation path's head
dimension 80, a GQA group of 4 and padded keys (``kv_len``).  The
reference's wrapper repeats the key heads; the port folds them, so a
difference in the fold would show here.
"""

import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels._build import find_nvcc
from repro_torch.kernels.ref import flash_attention_ref

# tests/test_kernels.py's sweep (b, hq, hkv, sq, sk, d), its causal x window
# grid (causal only where sq == sk, as there), plus D = 80 and a group of 4
SHAPES = [
    (1, 2, 1, 64, 64, 32),
    (2, 4, 2, 100, 100, 64),  # unaligned seq
    (1, 3, 3, 128, 256, 32),  # cross-length
    (1, 8, 2, 77, 77, 80),  # the path's head dim, GQA group 4, ragged
]
CASES = [
    (shape, causal, window)
    for shape in SHAPES
    for causal in (True, False)
    for window in (None, 33)
    if not (causal and shape[3] != shape[4])
]


def _tolerance(dtype):
    # tests/test_kernels.py's: bf16 inputs with fp32 accumulators differ by
    # a few ULPs of bf16 (~8e-3 relative) between the two routes
    return dict(rtol=8e-2, atol=4e-2) if dtype == "bfloat16" else dict(
        rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference():
    if jnp is None:
        pytest.skip("needs the JAX reference package")


def _qkv(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, hq, sq, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, hkv, sk, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, hkv, sk, d)) * 0.5).astype(np.float32))


def _port(q, k, v, dtype, **kw):
    tdt = getattr(torch, dtype)
    out = tops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)), **kw)
    assert out.dtype == tdt and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", CASES)
def test_flash_attention_matches_reference(reference, shape, causal, window,
                                           dtype):
    q, k, v = _qkv(*shape)
    got = _port(q, k, v, dtype, causal=causal, window=window)
    jdt = getattr(jnp, dtype)
    o_pal = jops.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
        window=window, backend="pallas", interpret=True, bq=64, bk=64)
    o_xla = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, backend="xla")
    tol = _tolerance(dtype)
    np.testing.assert_allclose(got, np.asarray(o_pal, np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(o_xla, np.float32), **tol)


def test_flash_attention_ref_equals_reference_oracle(reference):
    """The port's oracle on folded heads (group 1) is the reference's."""
    q, k, v = _qkv(1, 4, 4, 50, 50, 16, seed=3)
    fold = (lambda a: a.reshape(-1, *a.shape[2:]))
    for causal, window in ((True, None), (True, 7), (False, 9)):
        want = jref.flash_attention_ref(
            *(jnp.asarray(fold(a)) for a in (q, k, v)), causal=causal,
            window=window)
        got = flash_attention_ref(*(torch.from_numpy(fold(a))
                                    for a in (q, k, v)),
                                  causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_padded_keys_and_fully_masked_rows():
    """``kv_len`` hides the keys at and after it; a row that sees no key
    at all is 0, as the oracle writes it (``ref.py``: NaN rows to 0).
    Without causal order, rows at or past ``sk + window - 1`` see none."""
    q, k, v = _qkv(1, 4, 2, 40, 16, 80, seed=1)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    out = tops.flash_attention(tq_, tk_, tv_, causal=False, window=8)
    assert torch.isfinite(out).all()
    dead = 16 + 8 - 1
    assert not out[:, :, dead:].any() and out[:, :, :dead].abs().sum(-1).min() > 0
    # kv_len = 10 equals dropping the keys from 10 on
    got = tops.flash_attention(tq_, tk_, tv_, causal=False, kv_len=10)
    want = tops.flash_attention(tq_, tk_[:, :, :10], tv_[:, :, :10],
                                causal=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # a cache longer than the prompt: causal order hides the later slots
    got = tops.flash_attention(tq_[:, :, :12], tk_, tv_, causal=True,
                               kv_len=12)
    want = tops.flash_attention(tq_[:, :, :12], tk_[:, :, :12],
                                tv_[:, :, :12], causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert not tops.flash_attention(tq_, tk_, tv_, kv_len=0).any()


def test_strided_views_and_validation():
    """The op reads transposed views (a [B, S, H, D] cache) as they are,
    and refuses what the kernel does not take."""
    q, k, v = _qkv(2, 4, 2, 9, 9, 16, seed=2)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    bshd = [a.transpose(1, 2).contiguous().transpose(1, 2)
            for a in (tq_, tk_, tv_)]
    assert not bshd[1].is_contiguous()
    torch.testing.assert_close(tops.flash_attention(*bshd),
                               tops.flash_attention(tq_, tk_, tv_))
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention(tq_[:, :3], tk_, tv_)
    with pytest.raises(ValueError, match="share"):
        tops.flash_attention(tq_, tk_.double(), tv_)
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(tq_, tk_, tv_, window=0)
    assert tfa.flash_attention_cuda.launches == 0  # CPU: the plain version


@pytest.mark.gpu
def test_flash_attention_cuda_matches_plain_on_card():
    """The kernel against its plain version on the card: the sweep in
    three types, the path's shapes (32 q heads, 8 kv heads, D 80, bf16)
    at ragged lengths with the window, padded keys, a transposed cache
    view, D = 128, and fully masked rows (exact zeros)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = [(shape, causal, window, None, dt)
             for shape, causal, window in CASES
             for dt in ("float32", "bfloat16", "float16")]
    cases += [((1, 32, 8, s, s, 80), True, 4096, None, "bfloat16")
              for s in (17, 128, 1000)]
    cases += [((1, 32, 8, 300, 700, 80), True, 64, 300, "bfloat16"),
              ((2, 4, 1, 130, 130, 128), True, None, None, "float32"),
              ((1, 4, 2, 40, 16, 80), False, 8, None, "float32")]
    for (b, hq, hkv, sq, sk, d), causal, window, kv_len, dt in cases:
        q, k, v = _qkv(b, hq, hkv, sq, sk, d)
        tdt = getattr(torch, dt)
        args = [torch.from_numpy(a).to(dev, tdt) for a in (q, k, v)]
        n0 = tfa.flash_attention_cuda.launches
        got = tfa.flash_attention_cuda(*args, causal=causal, window=window,
                                       kv_len=kv_len)
        torch.cuda.synchronize()
        assert tfa.flash_attention_cuda.launches == n0 + 1
        want = tfa.flash_attention_plain(*args, causal=causal, window=window,
                                         kv_len=kv_len)
        tol = _tolerance("bfloat16" if dt != "float32" else dt)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if (sq, sk, window, causal) == (40, 16, 8, False):
            assert not got[:, :, 23:].any()
    # a [B, S, Hkv, D] cache read through its transposed view
    cache = torch.randn(1, 600, 8, 80, device=dev, dtype=torch.bfloat16)
    qv = torch.randn(1, 32, 500, 80, device=dev, dtype=torch.bfloat16)
    kt = cache.transpose(1, 2)
    got = tfa.flash_attention_cuda(qv, kt, kt, window=256, kv_len=500)
    want = tfa.flash_attention_plain(qv, kt, kt, window=256, kv_len=500)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tolerance("bfloat16"))
