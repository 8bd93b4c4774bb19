"""Serve over HTTP with the PyTorch port (twin of
``examples/serve_http.py``): boot the asyncio front end and drive it with
real sockets.

Classification (default) compiles the mini pattern-pruned CNN and
serves it through ``repro_torch.serve.session.classify_session``;
``--backend generate`` serves token generation through
``generate_session`` — per-slot decode positions, so freed slots are
refilled *mid-decode* while other requests keep decoding.  ``--device``
is where the model runs: ``cuda`` by default (raising without a card;
the spmm and flash kernels), ``cpu`` when asked (their plain versions).

All requests go through ``POST /v1/stream`` on one connection (chunked
NDJSON, completion order); the script then prints sustained req/s,
first-result p50/p99, and mean slot occupancy from the scheduler
metrics, plus a ``/metrics`` scrape excerpt.

  PYTHONPATH=src python examples/serve_http_torch.py [--device cpu]
  PYTHONPATH=src python examples/serve_http_torch.py --backend generate \\
      --requests 100 --trace-out serve_decode_trace.json --check

``--trace-out`` writes the Chrome trace-event JSON (Perfetto /
chrome://tracing) of the run — for ``--backend generate`` it carries the
``admit_mid_decode`` instants that ``benchmarks/check_baseline.py
--trace FILE --require-mid-decode`` validates in CI.  ``--check`` turns
the serving invariants (single trace, >= 90% occupancy, every request
served) into hard assertions.
"""

import argparse
import http.client
import json
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer
from repro_torch.serve.server import ServingServer
from repro_torch.serve.session import classify_session, generate_session

OCCUPANCY_FLOOR = 0.90


def _require(ok, what: str) -> None:
    """``--check``'s invariant: exit non-zero with ``what`` if it fails."""
    if not ok:
        raise SystemExit(f"check failed: {what}")


def _classify_setup(slots, tracer, dev):
    from repro_torch.core.pruning import (
        build_dictionaries,
        magnitude_prune,
        project_params,
    )
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.models.cnn import (
        conv_weight_names,
        init_cnn,
        mini_cnn_config,
    )

    cfg = mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    names = conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    dicts = build_dictionaries(params, names, 4)
    params, bits = project_params(params, dicts)
    prog = compile_network(
        cfg, params, bits, options=CompileOptions(tracer=tracer), device=dev
    )
    session = classify_session(prog, batch_slots=slots, tracer=tracer,
                               device=dev)
    rng = np.random.default_rng(0)

    def payload(i):
        return {"image": rng.normal(size=(1, 12, 12)).tolist()}

    return session, payload


def _generate_setup(arch, slots, prompt_len, tracer, dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import count_params, init_params
    from repro_torch.runtime.serve import ServeConfig

    cfg = get_smoke_config(arch)
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"{cfg.name}: {count_params(params):,} params")
    scfg = ServeConfig(
        batch_slots=slots, max_seq=prompt_len + 24, eos_id=-1
    )
    session = generate_session(
        cfg, statics, params, scfg, tracer=tracer, device=dev
    )
    rng = np.random.default_rng(0)

    def payload(i):
        # one prompt length (one prefill trace); staggered budgets so
        # completions interleave and freed slots refill mid-decode
        return {
            "prompt": rng.integers(1, cfg.vocab, prompt_len)
            .astype(int).tolist(),
            "max_new_tokens": 4 + i % 9,
        }

    return session, payload


def _stream(host, port, payloads, timeout=600):
    """POST /v1/stream and read the chunked NDJSON reply line by line."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(
            "POST", "/v1/stream",
            json.dumps({"requests": payloads}),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        lines = []
        while True:
            line = resp.readline()
            if not line:
                break
            lines.append(json.loads(line))
        return resp.status, lines
    finally:
        conn.close()


def _get(host, port, path, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("classify", "generate"),
                    default="classify")
    ap.add_argument("--arch", default="granite_3_2b",
                    help="smoke model for --backend generate")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--check", action="store_true",
                    help="assert the serving invariants (CI smoke mode)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    dev = resolve_device(None if args.device == "cuda" else "cpu")
    tracer = Tracer() if args.trace_out else None
    if args.backend == "classify":
        session, payload = _classify_setup(args.slots, tracer, dev)
    else:
        session, payload = _generate_setup(
            args.arch, args.slots, args.prompt_len, tracer, dev
        )

    srv = ServingServer(session, admit_wait_s=0.02)
    host, port = srv.start_in_thread()
    print(f"serving {args.backend} on http://{host}:{port}")
    try:
        payloads = [payload(i) for i in range(args.requests)]
        t0 = time.perf_counter()
        status, lines = _stream(host, port, payloads)
        dt = time.perf_counter() - t0

        m = session.metrics
        ok = [ln for ln in lines if ln.get("ok")]
        print(
            f"{len(ok)}/{args.requests} requests ok over HTTP "
            f"({args.slots} slots): {args.requests / dt:.1f} req/s "
            f"in {dt:.2f}s"
        )
        print(
            f"first result p50={m['first_result_p50_s'] * 1e3:.2f}ms "
            f"p99={m['first_result_p99_s'] * 1e3:.2f}ms; "
            f"occupancy={m['occupancy_mean']:.3f}; "
            f"batches={m['steps']}; traces={session.trace_count()}"
        )
        _, health = _get(host, port, "/healthz")
        print(f"/healthz {health}")
        _, metrics = _get(host, port, "/metrics")
        wanted = ("occupancy_mean", "completed_total",
                  "serve_http_requests_rate_per_s")
        for line in metrics.splitlines():
            if any(w in line for w in wanted) and "# " not in line:
                print(f"/metrics  {line}")

        if args.check:
            _require(status == 200 and len(lines) == args.requests,
                     f"HTTP {status}, {len(lines)} of {args.requests} lines")
            _require(len(ok) == args.requests, "every request must be served")
            _require(session.trace_count() == 1,
                     f"forward traced {session.trace_count()} times")
            _require(m["occupancy_mean"] >= OCCUPANCY_FLOOR,
                     f"occupancy {m['occupancy_mean']:.3f} < "
                     f"{OCCUPANCY_FLOOR}")
            if args.backend == "generate" and tracer is not None:
                mid = [
                    e for e in tracer.events()
                    if e.get("args", {}).get("event") == "admit_mid_decode"
                ]
                _require(mid, "no mid-decode admissions observed")
                print(f"check ok ({len(mid)} mid-decode admissions)")
            else:
                print("check ok")
    finally:
        srv.shutdown()
    if tracer is not None:
        tracer.write(args.trace_out)
        print(f"wrote {args.trace_out}")


if __name__ == "__main__":
    main()
