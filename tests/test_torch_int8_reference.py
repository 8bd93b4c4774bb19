"""The port's int8 path held against the benchmark's plain references.

On seeded mini nets on the CPU, served through ``InferenceService`` as
the benchmark serves (``h100bench.cell``):

  * the int8 logits lie within :data:`INT8_LIMIT` of the float64
    unquantized forward (``h100bench/reference_quant.py`` with
    ``bits=None``), and the plain reference at 4 bits, the control one
    step below int8, lies outside it;
  * the int8 logits equal a float64 forward over the program's own
    dequantized weights (``bp.dense()``) with the activations quantized
    per row, to one activation quantization step: this pins the kernel's
    plain version, the per-brick scales and ``quantize_rows``.

On the card (``-m gpu``): the int8 spmm at ImageNet's conv1_2 (16 x
224^2 patch rows) against the same float64 product.
"""

import copy
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import check, reference_quant, synth  # noqa: E402
from h100bench.cell import build_program, build_service  # noqa: E402
from h100bench.registry import BENCH_DIR, read_json  # noqa: E402
from h100bench.tests.tiny import TINY  # noqa: E402

from repro_torch.core.quantize import QMAX  # noqa: E402
from repro_torch.serve.api import Request  # noqa: E402

# Two mini nets: one brick a layer (128 x 128: the brick scale is the
# layer's), and 16 x 16 bricks (several scales a layer, as at VGG16).
NETS = {
    "one_brick": {**copy.deepcopy(TINY), "name": "one_brick",
                  "engine": {"block": 128, "tile": 128, "precision": "int8",
                             "mapping": "fixed"}},
    "bricks": {**copy.deepcopy(TINY), "name": "bricks",
               "conv_channels": [[3, 8], [8, 16], [16, 16], [16, 32]],
               "pool_after": [2, 4], "input_hw": 16, "num_classes": 10,
               "table_ii": {"sparsity": 0.8, "zero_pattern_ratio": 0.3,
                            "patterns_per_layer": [2, 3, 3, 4]},
               "engine": {"block": 16, "tile": 16, "precision": "int8",
                          "mapping": "fixed"}},
}
SEEDS = (1, 2, 3, 4)
CASES = [(n, s) for n in NETS for s in SEEDS]
# max_logit_err against the float64 unquantized forward (check.py's
# measure), set as the benchmark's int8 limit is set, from a control:
# over 12 seeds of 16 images the served int8 logits read at most 0.033
# (one_brick) and 0.019 (bricks), the plain reference at 8 bits at most
# 0.026, at 4 bits at least 0.167 and 0.130.  The limit sits 1.8 x above
# the program's worst and 2.2 x below the 4-bit control's least.
INT8_LIMIT = 0.06
# one activation quantization step, as a share of the logits' scale: a
# rounding of one activation that an ulp moves across a half-step flips
# by one step; an image that meets no such flip agrees to float32
# rounding (MEDIAN_LIMIT)
STEP = 1.0 / QMAX
MEDIAN_LIMIT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _served(net: str, seed: int):
    """(config, params, program, images, served int8 logits) of ``net``
    with weights and 16 images from ``seed``."""
    config = NETS[net]
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, seed, "cpu")
    program = build_program(config, params, bits, "cpu")
    hw = int(config["input_hw"])
    x = torch.randn((16, 3, hw, hw),
                    generator=torch.Generator().manual_seed(seed))
    svc = build_service(program, config, "cpu")
    served = np.stack([r.logits for r in svc.serve(
        [Request(image=img) for img in x.numpy()])])
    return config, params, program, x, served


def _reference(net: str, seed: int, bits):
    config, params, _, x, _ = _served(net, seed)
    return reference_quant.logits(config, params, x, bits=bits).numpy()


@pytest.mark.parametrize("net,seed", CASES)
def test_int8_logits_within_the_limit_of_the_float64_forward(net, seed):
    served = _served(net, seed)[-1]
    err = check.logit_errors(served, _reference(net, seed, None))
    assert err.max() <= INT8_LIMIT, err.max()


@pytest.mark.parametrize("net,seed", CASES)
def test_int4_control_fails_the_limit(net, seed):
    exact = _reference(net, seed, None)
    err = check.logit_errors(_reference(net, seed, 4), exact)
    assert err.max() > INT8_LIMIT, err.max()


def _dequantized_params(program) -> dict:
    """The program's weights as ``reference_quant`` takes them, float64:
    each layer's dense ``[K, N]`` (``bp.dense()`` dequantizes the bricks
    and puts the columns back in the layer's order) cut to its real rows
    and columns."""
    out = {}
    for op in program.convs:
        k = op.kernel
        w = op.bp.dense().double()[:op.c_in * k * k, :op.c_out]
        out[op.name] = {"w": w.T.reshape(op.c_out, op.c_in, k, k),
                        "b": torch.as_tensor(op.bias).double()}
    fc = program.fc
    out["fc"] = {"w": fc.bp.dense().double()[:fc.d_in, :fc.d_out],
                 "b": torch.as_tensor(fc.bias).double()}
    return out


@pytest.mark.parametrize("net,seed", CASES)
def test_int8_logits_equal_the_dequantized_weights_forward(net, seed):
    config, _, program, x, served = _served(net, seed)
    want = reference_quant.forward(config, _dequantized_params(program),
                                   x.double(), 8, weights=False).numpy()
    err = check.logit_errors(served, want)
    assert err.max() <= STEP, err.max()
    assert np.median(err) <= MEDIAN_LIMIT, np.median(err)


def _card():
    from repro_torch.kernels._build import find_nvcc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.gpu
def test_int8_spmm_at_imagenet_conv1_2_on_card():
    """The served int8 spmm of ``vgg16_imagenet_int8``'s conv1_2 over 16 x
    224^2 patch rows (802,816 x 640): the kernel's rows times the row
    scales equal the float64 product of the same quantized rows and the
    dequantized weights to float32 rounding (each brick's partial is an
    exact integer; 5 bricks a tile fold in float32)."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels.ops import pattern_spmm
    from repro_torch.kernels.patches import conv_patches_cuda

    dev = _card()
    config = read_json(BENCH_DIR / "configs" / "vgg16_imagenet_int8.json")
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, 2**31 + 5, dev)
    op = build_program(config, params, bits, dev).convs[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.relu(torch.randn((16, 64, 224, 224), generator=gen,
                               device=dev))
    patches = conv_patches_cuda(x, 3, op.bp.k_in)
    assert patches.shape == (16 * 224 * 224, 640)
    y = pattern_spmm(patches, op.bp)[:, :op.c_out]
    xq, scale = quantize_rows(patches)
    del patches
    w = op.bp.dense().double()[:, :op.c_out]
    want = (xq.double() * scale.double()[:, None]) @ w
    del xq
    err = (y.double() - want).abs().amax(dim=1)
    rel = err / want.abs().amax(dim=1).clamp_min(1.0)
    assert float(rel.max()) <= 1e-5, float(rel.max())
