"""Port's token-generation service and HTTP front end (CPU).

The same prompts go through the JAX ``DecodeService`` and the port's, on
the ``granite_3_2b`` smoke model with the same parameters (float32, a
float32 cache): the same greedy tokens, and each decode step's logits
within 1e-5 relative to the largest.  Inside the port, mid-decode
admission gives every request the tokens of a solo run with decode run
at one input signature (``tests/test_serve.py``'s property).  Then the
port's ``ServingServer`` over real sockets, serving generation and
classification, and shedding with 429 when its queue is full.
"""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.models.transformer import init_params as j_init_params
from repro.runtime.serve import DecodeService as JDecodeService
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.serve import Request as JRequest

from repro_torch.configs import get_smoke_config
from repro_torch.engine import compile_network, make_forward
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.models.cnn import init_cnn, mini_cnn_config
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.transformer import init_params, init_statics
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.serve import DecodeService, ServeConfig
from repro_torch.serve.api import Request
from repro_torch.serve.server import ServingServer
from repro_torch.serve.session import (
    ServeSession,
    classify_session,
    generate_session,
)

SCFG = dict(batch_slots=2, max_seq=32, eos_id=-1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(reference cfg, params, statics), (port cfg, params, statics)."""
    jcfg = j_smoke("granite_3_2b")
    jp, _, jst = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_smoke_config("granite_3_2b")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, jp, jst), (tcfg, tp, init_statics(tcfg, "cpu"))


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def test_same_greedy_tokens_as_reference(lm):
    """Lockstep: the same submissions, one step at a time, through both
    services; after each step the decode logits agree and, at the end,
    every request's tokens are equal."""
    (jcfg, jp, jst), (tcfg, tp, tst) = lm
    jsvc = JDecodeService(jcfg, jst, jp, JServeConfig(
        **SCFG, cache_dtype="float32"), capture_logits=True)
    tsvc = DecodeService(tcfg, tst, tp, ServeConfig(
        **SCFG, cache_dtype="float32"), capture_logits=True, device="cpu")
    prompts = _prompts(jcfg.vocab, (6, 4, 9, 5, 3, 7))
    news = (5, 3, 6, 4, 2, 5)
    jreqs = [JRequest(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    treqs = [Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    bursts = (3, 1, 2)  # the queue refills slots mid-decode
    it = iter(range(len(prompts)))
    for burst in bursts:
        for _ in range(burst):
            i = next(it)
            jsvc.submit(jreqs[i])
            tsvc.submit(treqs[i])
        for _ in range(2):
            jsvc.step()
            tsvc.step()
            lj, lt = jsvc.last_logits, tsvc.last_logits
            assert (lj is None) == (lt is None)
            if lj is not None:
                err = np.abs(lt - lj).max() / max(1.0, np.abs(lj).max())
                assert err <= 1e-5
    while jsvc.has_work() or tsvc.has_work():
        jsvc.step()
        tsvc.step()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs)
    assert tsvc.trace_count() == 1
    assert tsvc.prefill_trace_count() == len(set(map(len, prompts)))


def test_step_functions_and_serve_loop_match_reference(lm):
    """``make_prefill_step`` on a batch of equal-length prompts, then
    ``make_decode_step`` at one shared position, greedy: the tokens of
    the reference's step functions; ``ServeLoop`` drains a list to the
    same tokens as ``DecodeService``."""
    from repro.models.transformer import init_cache as j_init_cache
    from repro.runtime.serve import make_decode_step as j_decode
    from repro.runtime.serve import make_prefill_step as j_prefill

    from repro_torch.models.transformer import init_cache
    from repro_torch.runtime.serve import (
        ServeLoop,
        make_decode_step,
        make_prefill_step,
    )

    (jcfg, jp, jst), (tcfg, tp, tst) = lm
    jscfg = JServeConfig(**SCFG, cache_dtype="float32")
    tscfg = ServeConfig(**SCFG, cache_dtype="float32")
    toks = np.stack(_prompts(jcfg.vocab, (7, 7), seed=4))
    jc = j_init_cache(jst, 2, 32, dtype=jax.numpy.float32)
    tc = init_cache(tst, 2, 32, dtype=torch.float32)
    jt, jc = j_prefill(jcfg, jst, jscfg)(jp, jc, jax.numpy.asarray(toks))
    tt, tc = make_prefill_step(tcfg, tst, tscfg)(
        tp, tc, torch.as_tensor(toks, dtype=torch.long))
    jdec, tdec = j_decode(jcfg, jst, jscfg), make_decode_step(tcfg, tst, tscfg)
    for pos in range(7, 10):
        assert tt.tolist() == np.asarray(jt).tolist()
        jt, jc = jdec(jp, jc, jt, jax.numpy.int32(pos))
        tt, tc = tdec(tp, tc, tt, torch.tensor(pos))
    assert tt.tolist() == np.asarray(jt).tolist()
    # temperature > 0 with a generator samples, reproducibly per seed
    hot = make_decode_step(tcfg, tst, ServeConfig(**SCFG, temperature=1.0))
    draws = [hot(tp, init_cache(tst, 2, 32, dtype=torch.float32), tt,
                 torch.tensor(3), rng=torch.Generator().manual_seed(7))[0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert ((draws[0] >= 0) & (draws[0] < tcfg.vocab)).all()
    prompts = _prompts(tcfg.vocab, (5, 3, 6), seed=6)
    loop = ServeLoop(tcfg, tst, tp, ServeConfig(**SCFG), device="cpu")
    reqs = loop.generate([Request(prompt=p, max_new_tokens=3)
                          for p in prompts])
    assert [r.output for r in reqs] == [
        _solo_tokens(tcfg, tst, tp, p, 3) for p in prompts]
    assert loop.metrics["completed"] == 3


def _solo_tokens(tcfg, tst, tp, prompt, n):
    svc = DecodeService(tcfg, tst, tp, ServeConfig(**SCFG), device="cpu")
    req = Request(prompt=prompt, max_new_tokens=n)
    svc.submit(req)
    svc.run()
    return list(req.output)


def test_mid_decode_admission_bit_identical_and_single_trace(lm):
    _, (tcfg, tp, tst) = lm
    tr = Tracer()
    svc = DecodeService(tcfg, tst, tp, ServeConfig(**SCFG), tracer=tr,
                        device="cpu")
    p1, p2, p3 = _prompts(tcfg.vocab, (6, 4, 5))
    r1 = Request(prompt=p1, max_new_tokens=10)
    r2 = Request(prompt=p2, max_new_tokens=3)
    r3 = Request(prompt=p3, max_new_tokens=4)
    svc.submit(r1)
    svc.submit(r2)
    while not r2.done:
        svc.step()
    assert not r1.done  # its neighbour finished mid-generation
    svc.submit(r3)
    svc.step()  # refills the freed slot while r1 is between decode steps
    assert r3.output and not r1.done
    svc.run()
    assert svc.trace_count() == 1
    for prompt, req in ((p1, r1), (p2, r2), (p3, r3)):
        assert list(req.output) == _solo_tokens(
            tcfg, tst, tp, prompt, req.max_new_tokens)
    admits = [e for e in tr.events()
              if e.get("args", {}).get("event") == "admit_mid_decode"]
    assert len(admits) == 1 and admits[0]["args"]["pos"] == len(p3)
    assert svc.scheduler.metrics.first_results == 3
    assert svc.metrics["first_result_p50_s"] >= 0.0


def test_entry_points_raise_without_cuda(lm, monkeypatch):
    _, (tcfg, tp, tst) = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: DecodeService(tcfg, tst, tp, ServeConfig(**SCFG)),
        lambda: generate_session(tcfg, tst, tp, ServeConfig(**SCFG)),
        lambda: lm_params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: init_statics(tcfg),
        lambda: init_params(tcfg, torch.Generator()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# HTTP front end, over real sockets
# ---------------------------------------------------------------------------


def _post(host, port, path, payload, timeout=60):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(host, port, path, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_generate_end_to_end(lm):
    _, (tcfg, tp, tst) = lm
    sess = generate_session(tcfg, tst, tp, ServeConfig(**SCFG), device="cpu")
    srv = ServingServer(sess, admit_wait_s=0.002)
    host, port = srv.start_in_thread()
    try:
        prompts = _prompts(tcfg.vocab, (5, 3, 8, 4, 6), seed=9)
        want = [_solo_tokens(tcfg, tst, tp, p, 4) for p in prompts]
        status, _, body = _post(host, port, "/v1/run", {
            "prompt": prompts[0].tolist(), "max_new_tokens": 4})
        out = json.loads(body)
        assert status == 200 and out["ok"] and out["tokens"] == want[0]
        results = [None] * len(prompts)

        def client(i):
            st, _, b = _post(host, port, "/v1/run", {
                "prompt": prompts[i].tolist(), "max_new_tokens": 4})
            results[i] = (st, json.loads(b))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (st, out) in enumerate(results):
            assert st == 200 and out["tokens"] == want[i]
        status, _, body = _post(host, port, "/v1/stream", {"requests": [
            {"prompt": p.tolist(), "max_new_tokens": 4} for p in prompts[:3]]})
        lines = [json.loads(ln) for ln in body.decode().strip().splitlines()]
        assert status == 200
        assert sorted(ln["index"] for ln in lines) == [0, 1, 2]
        for ln in lines:
            assert ln["ok"] and ln["tokens"] == want[ln["index"]]
        status, body = _get(host, port, "/metrics")
        assert status == 200
        assert "decode_service_completed_total" in body.decode()
        status, _, _ = _post(host, port, "/v1/run", {"prompt": []})
        assert status == 400
        assert sess.trace_count() == 1
        assert srv.completed == 1 + len(prompts) + 3
    finally:
        srv.shutdown()


def test_http_classify_end_to_end():
    cfg = mini_cnn_config(4, 12, (8, 16, 16))
    params = init_cnn(cfg, torch.Generator().manual_seed(0))
    prog = compile_network(cfg, params, device="cpu")
    images = np.random.default_rng(13).normal(size=(6, 1, 12, 12)).astype(
        np.float32)
    want = make_forward(prog, device="cpu")(images).argmax(-1).tolist()
    sess = classify_session(prog, batch_slots=4, device="cpu")
    srv = ServingServer(sess, admit_wait_s=0.002)
    host, port = srv.start_in_thread()
    try:
        status, _, body = _post(host, port, "/v1/stream", {"requests": [
            {"image": img.tolist()} for img in images]})
        lines = [json.loads(ln) for ln in body.decode().strip().splitlines()]
        assert status == 200 and len(lines) == len(images)
        for ln in lines:
            assert ln["ok"] and ln["label"] == want[ln["index"]]
        status, body = _get(host, port, "/healthz")
        assert status == 200 and json.loads(body)["batch_slots"] == 4
        status, body = _get(host, port, "/metrics")
        assert "engine_service_completed_total" in body.decode()
        assert sess.trace_count() == 1
    finally:
        srv.shutdown()


class _SlowBackend:
    """Protocol-conforming fake backend with a controllable step time —
    makes HTTP-level shedding deterministic."""

    def __init__(self, batch_slots=1, max_queue=1, step_s=0.3):
        self.scheduler = SlotScheduler(batch_slots, max_queue=max_queue)
        self.step_s = step_s

    def try_submit(self, req):
        return self.scheduler.try_submit(req)

    def submit(self, req):
        self.scheduler.submit(req)

    def has_work(self):
        return self.scheduler.has_work()

    def step(self):
        self.scheduler.refill()
        live = list(self.scheduler.live())
        if not live:
            return []
        time.sleep(self.step_s)
        self.scheduler.record_step()
        done = []
        for slot, req in live:
            req.output.append(0)
            req.done = True
            self.scheduler.complete(slot)
            done.append(req)
        return done

    def trace_count(self):
        return 1

    @property
    def metrics(self):
        return self.scheduler.snapshot()

    def metrics_text(self):
        return self.scheduler.metrics.to_prometheus(prefix="fake")

    def reset_metrics(self):
        self.scheduler.reset_metrics()

    def warmup(self):
        pass


def test_http_load_shedding_429_and_admitted_never_dropped():
    backend = _SlowBackend(batch_slots=1, max_queue=1, step_s=0.4)
    srv = ServingServer(ServeSession(backend), admit_wait_s=0.0)
    host, port = srv.start_in_thread()
    outcomes = []
    lock = threading.Lock()

    def client():
        st, headers, body = _post(host, port, "/v1/run",
                                  {"prompt": [1, 2]}, timeout=120)
        with lock:
            outcomes.append((st, headers, body))

    threads = [threading.Thread(target=client) for _ in range(6)]
    for t in threads[:2]:  # admit up to capacity (1 slot + 1 queued) ...
        t.start()
    time.sleep(0.15)
    for t in threads[2:]:  # ... then burst while the worker is mid-step
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.shutdown()
    ok = [o for o in outcomes if o[0] == 200]
    shed = [o for o in outcomes if o[0] == 429]
    assert len(ok) + len(shed) == 6 and ok and shed
    for _, headers, body in shed:
        assert int(headers["Retry-After"]) >= 1
        payload = json.loads(body)
        assert payload["ok"] is False and payload["error"] == "overloaded"
        assert payload["retry_after_s"] > 0
    m = backend.scheduler.metrics
    assert m.completed == m.admitted == len(ok)
    assert m.rejected == len(shed)
