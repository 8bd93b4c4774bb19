"""The yardstick's pieces: the nonzero counts, the frozen synthesizer and
the plain reference."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h100bench import counts, reference, synth  # noqa: E402
from h100bench.registry import BENCH_DIR, read_json  # noqa: E402
from h100bench.tests.tiny import TINY  # noqa: E402

MINI = {"conv_channels": [[1, 2], [2, 3]], "pool_after": [1], "kernel": 3,
        "input_hw": 4, "num_classes": 5}


def test_counts_match_a_hand_count():
    """Two convs (4x4, pool, 2x2) and an FC 3 -> 5 over 2 images, with
    7, 20 and 15 nonzero weights."""
    nnz = {"conv1": 7, "conv2": 20, "fc": 15}
    got = counts.layer_counts(MINI, nnz, batch=2)
    assert [c.name for c in got] == ["conv1", "conv2", "fc"]
    # conv1: 2 images x 16 windows; in 1 channel, out 2
    assert (got[0].rows, got[0].ops, got[0].bytes) == (
        32, 2 * 32 * 7, 4 * (32 * 1 + 7 + 32 * 2))
    # conv2: 2 x 4 windows after the pool; in 2, out 3
    assert (got[1].rows, got[1].ops, got[1].bytes) == (
        8, 2 * 8 * 20, 4 * (8 * 2 + 20 + 8 * 3))
    # fc: 2 rows of 3 features to 5 classes
    assert (got[2].rows, got[2].ops, got[2].bytes) == (
        2, 2 * 2 * 15, 4 * (2 * 3 + 15 + 2 * 5))
    assert counts.image_flops(MINI, nnz) == 2 * 16 * 7 + 2 * 4 * 20 + 2 * 15
    peaks = {"fp32_flops_per_s": 100.0, "hbm_bytes_per_s": 1000.0}
    assert counts.least_seconds(got[0], peaks) == max(448 / 100, 412 / 1000)


def test_nnz_counts_nonzero_weights_not_bricks():
    w = torch.zeros(3, 2, 3, 3)
    w[0, 0, 1, 1] = 1.0
    w[2, 1, :, 0] = -2.0
    assert counts.nnz_of({"conv1": {"w": w, "b": torch.ones(3)}}) == {
        "conv1": 4}


@pytest.mark.parametrize("config", ["vgg16_cifar10", "vgg16_imagenet"])
def test_nonzero_flops_of_the_configurations(config):
    """The counts the rooflines and mfu rest on: 5.20 GFLOP an image on
    ImageNet, 0.0866 on CIFAR-10, against 36.9 and 0.753 in stored
    bricks."""
    cfg = read_json(BENCH_DIR / "configs" / f"{config}.json")
    bits = synth.network_patterns(cfg)
    nnz = {k: int(((b[..., None] >> np.arange(9)) & 1).sum())
           for k, b in bits.items()}
    nnz["fc"] = 512 * cfg["num_classes"]
    want = {"vgg16_cifar10": 0.0866, "vgg16_imagenet": 5.203}[config]
    assert counts.image_flops(cfg, nnz) / 1e9 == pytest.approx(want,
                                                               rel=1e-3)
    sparsity = 1 - sum(v for k, v in nnz.items() if k != "fc") / sum(
        b.size * 9 for b in bits.values())
    assert sparsity == pytest.approx(cfg["table_ii"]["sparsity"], abs=2e-3)


@pytest.mark.parametrize("dataset", ["cifar10", "imagenet"])
def test_synthesizer_copy_equals_the_programs(dataset):
    from repro_torch.core.synthetic import TABLE_II, synthesize_network

    cfg = read_json(BENCH_DIR / "configs" / f"vgg16_{dataset}.json")
    stats = TABLE_II[dataset]
    t2 = cfg["table_ii"]
    assert (t2["sparsity"], t2["zero_pattern_ratio"],
            tuple(t2["patterns_per_layer"]), cfg["input_hw"]) == (
        stats.sparsity, stats.zero_pattern_ratio,
        stats.patterns_per_layer, stats.input_hw)
    _, theirs = synthesize_network(dataset, seed=3)
    ours = synth.synthesize_network(cfg, seed=3)
    assert len(ours) == len(theirs)
    for (spec, pats, bits, w), layer in zip(ours, theirs):
        assert (spec.c_in, spec.c_out, spec.out_hw) == (
            layer.spec.c_in, layer.spec.c_out, layer.spec.out_hw)
        assert sorted(pats) == sorted(layer.pdict.patterns)
        assert np.array_equal(bits, layer.pattern_bits)
        assert w.dtype == layer.weights.dtype
        assert np.array_equal(w, layer.weights)


def test_device_weights_lie_inside_their_patterns():
    bits = synth.network_patterns(TINY)
    a = synth.device_weights(TINY, bits, 11, "cpu")
    b = synth.device_weights(TINY, bits, 11, "cpu")
    c = synth.device_weights(TINY, bits, 12, "cpu")
    for name, bt in bits.items():
        mask = (bt[..., None] >> np.arange(9)) & 1
        w = a[name]["w"].reshape(*bt.shape, 9).numpy()
        assert np.array_equal(w != 0, mask.astype(bool))
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert not torch.equal(a[name]["w"], c[name]["w"])
        assert not a[name]["b"].any()
    assert a["fc"]["w"].shape == (16, 5) and a["fc"]["b"].abs().sum() > 0


def test_reference_equals_the_programs_dense_forward():
    """The frozen reference computes what the program's ``cnn_apply``
    computes, at a mini size on the CPU."""
    from repro_torch.models.cnn import cnn_apply

    from h100bench.cell import cnn_config

    bits = synth.network_patterns(TINY)
    params = synth.device_weights(TINY, bits, 5, "cpu")
    x = torch.randn(6, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    theirs = cnn_apply(cnn_config(TINY), params, x)
    ours = reference.forward(TINY, params, x)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)
    exact = reference.logits(TINY, params, x, block=4)
    assert exact.dtype == torch.float64
    torch.testing.assert_close(exact.float(), theirs, rtol=0, atol=1e-5)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 2**-11), 3.0 + 2**-12])
    got = reference.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0,
                         -(1.0 + 2**-10), 3.0])
    assert torch.equal(got, want)
