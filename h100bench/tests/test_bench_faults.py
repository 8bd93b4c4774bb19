"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a chip (``run_cell`` on the CPU,
at the tiny size) and drives the rest of a run with a fault planted in
the service the window times: half the batch left out (its rows take the
mean of the rest), or one answer altered where it is produced.  A state
left unchanged (training) and the exchange between chips (one chip) are
faults these cells cannot have.
"""

import pytest

torch = pytest.importorskip("torch")

from h100bench import cell as cell_mod  # noqa: E402
from h100bench.registry import Cell  # noqa: E402
from h100bench.tests.tiny import BACKLOG, OPEN, TINY  # noqa: E402


def _like(forward, fn):
    """``fn`` with the attributes of the forward it replaces."""
    fn.__dict__.update(forward.__dict__)
    return fn


def _half_batch(forward):
    def fn(x, valid=None):
        out = forward(x, valid)
        half = out.shape[0] // 2
        return torch.cat([out[:half],
                          out[:half].mean(0, keepdim=True).expand(
                              out.shape[0] - half, -1)])
    return _like(forward, fn)


def _answer_altered(forward):
    def fn(x, valid=None):
        out = forward(x, valid).clone()
        out[0, out[0].argmax()] = out[0].min()
        return out
    return _like(forward, fn)


FAULTS = {"none": None, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _run(monkeypatch, mix, fault):
    build = cell_mod.build_service

    def faulty(*a, **k):
        svc = build(*a, **k)
        if FAULTS[fault] is not None:
            svc._forward = FAULTS[fault](svc._forward)
        return svc

    monkeypatch.setattr(cell_mod, "build_service", faulty)
    cell = Cell({"name": "tiny", "chips": 1}, TINY, mix, [], [])
    return cell_mod.run_cell(cell, seed=2**32 + 5, seconds=0.3, trace=False,
                             device="cpu")


@pytest.mark.parametrize("mix", [BACKLOG, OPEN], ids=["backlog", "open"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_make_a_run_not_correct(monkeypatch, mix, fault):
    res = _run(monkeypatch, mix, fault)
    assert res["correct"] == (fault == "none"), res["checks"]
    assert res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
