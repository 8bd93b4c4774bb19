"""Unified serving contract: one ``Request``/``Response`` pair for every
front end.

Historically the repo grew two request models — classification's
``engine/service.ClassifyRequest`` (image in, logits/label out) and
generation's ``runtime/serve.Request`` (prompt in, tokens out).  Both are
now thin deprecation shims over the single :class:`Request` here, and the
HTTP server, the :class:`~repro.serve.session.ServeSession` facade, and
both backends speak only this contract.

This module is deliberately leaf-level: stdlib + numpy only, no imports
from anywhere else in ``repro``, so the engine and runtime packages can
import it without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["Request", "Response", "Overloaded"]


class Overloaded(RuntimeError):
    """The service is shedding load: the bounded queue is full.

    Carries ``retry_after_s`` — the backpressure-derived hint a client
    should wait before retrying (HTTP front ends surface it as a 429
    with a ``Retry-After`` header).  This is the *only* overload signal
    on the public serve path; the scheduler-internal
    ``SchedulerFull`` never escapes a session or the HTTP server.
    """

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"service overloaded; retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass
class Request:
    """One unit of serving work, for either workload.

    Exactly one of ``image`` (classification: ``[C, H, W]`` float) or
    ``prompt`` (generation: ``[L]`` int tokens) is set.  Result fields
    are filled in place as the backend serves the request —
    ``logits``/``label`` for classification, ``output`` (one appended
    token per decode step, so a streaming front end can flush tokens as
    they land) for generation — and ``done`` flips when it completes.
    """

    image: np.ndarray | None = None
    prompt: np.ndarray | None = None
    max_new_tokens: int = 32
    # results (filled by the serving backend)
    logits: np.ndarray | None = None
    label: int | None = None
    output: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def kind(self) -> str:
        return "classify" if self.image is not None else "generate"

    def response(self) -> "Response":
        """The success :class:`Response` for this (completed) request."""
        return Response(
            ok=self.done,
            kind=self.kind,
            label=self.label,
            logits=self.logits,
            tokens=list(self.output) if self.output else None,
        )


@dataclasses.dataclass
class Response:
    """What a front end returns for one request.

    ``ok=False`` carries an ``error`` string and, for shed requests, the
    ``retry_after_s`` backpressure hint.
    """

    ok: bool = True
    kind: str | None = None
    label: int | None = None
    logits: np.ndarray | None = None
    tokens: list[int] | None = None
    error: str | None = None
    retry_after_s: float | None = None

    @classmethod
    def shed(cls, retry_after_s: float) -> "Response":
        return cls(ok=False, error="overloaded",
                   retry_after_s=float(retry_after_s))

    def to_json(self) -> dict[str, Any]:
        """JSON-serializable dict (numpy arrays listed, Nones dropped)."""
        out: dict[str, Any] = {"ok": self.ok}
        if self.kind is not None:
            out["kind"] = self.kind
        if self.label is not None:
            out["label"] = int(self.label)
        if self.logits is not None:
            out["logits"] = np.asarray(self.logits).tolist()
        if self.tokens is not None:
            out["tokens"] = [int(t) for t in self.tokens]
        if self.error is not None:
            out["error"] = self.error
        if self.retry_after_s is not None:
            out["retry_after_s"] = self.retry_after_s
        return out
