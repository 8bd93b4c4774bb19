"""The control (the reference in TF32, the step below the configuration's
float32) fails each configuration's limit, and the program passes it.

On the CPU: ``vgg16_cifar10`` at its widths on one batch of its pool, one
seed, and the tiny net on three.  On the card (``-m gpu``): both
configurations at the cell's own size on three seeds, with the card's
own TF32 as well.
"""

import pytest

torch = pytest.importorskip("torch")

from h100bench.control import readings  # noqa: E402
from h100bench.registry import BENCH_DIR, read_json  # noqa: E402
from h100bench.tests.tiny import TINY  # noqa: E402


def _config(name):
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def _holds(config, row):
    limit = config["limits"]["max_logit_err"]
    assert row["program"] <= limit < row["control_tf32"], row
    if "card_tf32" in row:
        assert limit < row["card_tf32"], row


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_tiny_limit(seed):
    _holds(TINY, readings(TINY, {"image_pool_batches": 4}, seed, "cpu"))


def test_control_fails_the_cifar10_limit_on_the_cpu():
    config = _config("vgg16_cifar10")
    _holds(config, readings(config, {"image_pool_batches": 1}, 2**31 + 1,
                            "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vgg16_imagenet", "vgg16_cifar10"])
def test_control_fails_the_limit_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = _config(name)
    mix = read_json(BENCH_DIR / "traffic" / "bulk.json")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        _holds(config, readings(config, mix, seed, torch.device("cuda")))
