"""The ``submit``/``stream``/``run`` facade over either serving backend.

Port of ``src/repro/serve/session.py`` (pure Python, copied).
:class:`ServeSession` wraps a step-based backend —
``engine.service.InferenceService`` (classification) or
``runtime.serve.DecodeService`` (generation) — behind the one public
verb set the HTTP server and clients use:

  * :meth:`submit` — enqueue one request; raises
    :class:`~repro_torch.serve.api.Overloaded` (with a backpressure-derived
    ``retry_after_s``) instead of ever surfacing the scheduler-internal
    ``SchedulerFull``;
  * :meth:`stream` — drain a list of requests, yielding each as it
    completes (completion order, not submission order);
  * :meth:`run` — drain a list of requests and return them.

``stream``/``run`` interleave submission with stepping, so a bounded
queue is backpressure (work waits), never a rejection — shedding only
applies to :meth:`submit`'s one-shot admission, the RPC path.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from repro_torch.serve.api import Overloaded, Request

__all__ = ["ServeSession", "classify_session", "generate_session"]


class ServeSession:
    """Uniform serving session over a step-based backend.

    The backend protocol (both backends implement it): ``try_submit``,
    ``step``, ``has_work``, ``scheduler``, ``trace_count``, ``metrics``,
    ``metrics_text``, ``reset_metrics``.
    """

    def __init__(self, backend):
        self.backend = backend

    # ------------------------------------------------------------- verbs

    def submit(self, request: Request) -> Request:
        """Enqueue one request for the serving loop.

        Raises :class:`Overloaded` with a retry hint when the bounded
        queue is full (the scheduler counts the rejection), and
        ``ValueError`` on malformed payloads.  Never raises
        ``SchedulerFull``.
        """
        if not self.backend.try_submit(request):
            raise Overloaded(self.backend.scheduler.retry_after_hint())
        return request

    def stream(self, requests: Iterable[Request]) -> Iterator[Request]:
        """Drain ``requests``, yielding each the moment it completes.

        Submission interleaves with stepping: a bounded queue throttles
        admission instead of rejecting, so every request is eventually
        served.
        """
        pending = list(requests)
        while pending or self.backend.has_work():
            while pending and self.backend.scheduler.has_capacity():
                self.backend.submit(pending.pop(0))
            yield from self.backend.step()

    def run(self, requests: Iterable[Request]) -> list[Request]:
        """Drain ``requests`` to completion and return them (in the
        original order; see :meth:`stream` for completion order)."""
        requests = list(requests)
        for _ in self.stream(requests):
            pass
        return requests

    # ------------------------------------------------------- pass-through

    def step(self) -> list[Request]:
        return self.backend.step()

    def has_work(self) -> bool:
        return self.backend.has_work()

    @property
    def scheduler(self):
        return self.backend.scheduler

    def trace_count(self) -> int:
        return self.backend.trace_count()

    @property
    def metrics(self) -> dict:
        return self.backend.metrics

    def metrics_text(self) -> str:
        return self.backend.metrics_text()

    def reset_metrics(self) -> None:
        self.backend.reset_metrics()

    def warmup(self) -> None:
        """Run the serving path once before taking traffic, then reset the
        metrics window — so the first real request doesn't pay one-time
        set-up and the served-traffic metrics exclude any warm batch."""
        native = getattr(self.backend, "warmup", None)
        if native is not None:
            # classification: run the fixed batch shape directly, no
            # synthetic request through the scheduler
            native()
        else:
            # generation: drive one tiny request through the real
            # admit/decode path
            req = Request(prompt=np.ones(4, np.int32), max_new_tokens=2)
            self.backend.submit(req)
            while self.backend.has_work():
                self.backend.step()
        self.backend.reset_metrics()
        if hasattr(self.backend, "reset_stats"):
            self.backend.reset_stats()


def classify_session(program, **kwargs) -> ServeSession:
    """A :class:`ServeSession` serving classification over a compiled
    program (kwargs forward to ``engine.service.InferenceService``)."""
    from repro_torch.engine.service import InferenceService

    return ServeSession(InferenceService(program, **kwargs))


def generate_session(cfg, statics, params, scfg, **kwargs) -> ServeSession:
    """A :class:`ServeSession` serving token generation with mid-decode
    admission (kwargs forward to ``runtime.serve.DecodeService``)."""
    from repro_torch.runtime.serve import DecodeService

    return ServeSession(DecodeService(cfg, statics, params, scfg, **kwargs))
