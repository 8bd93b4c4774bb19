"""Traffic-serving front end for compiled programs.

Port of ``repro/engine/service.py``.  ``InferenceService``
serves classification requests through the continuous-batching
scheduler (``engine/scheduler.py``): an optionally bounded request queue,
a fixed number of batch slots refilled as they free up, and per-request
latency / occupancy metrics.

Every executed batch has the same ``[batch_slots, C, H, W]`` shape — free
slots ride along as zero-padded dead rows flagged by a validity mask —
so the forward runs one input signature (``trace_count() == 1``) however
requests arrive.  ``channel_norm`` is per-sample, which makes that safe:
a request's logits are bit-identical alone, co-batched, or next to dead
slots.  With ``collect_stats=True`` every batch also measures its
activation-skip counters; the validity mask keeps dead slots out of the
counters and the window totals, so the accumulated ``activation_stats``
equal a one-shot stats forward over exactly the served images.

With ``mesh=`` every batch executes sharded over a ``DeviceMesh``
(``engine/executor.py``), SPMD style: every rank runs its own service and
submits the same requests in the same order.  The scheduler's batching
depends only on that order (it reads the clock for the latency metrics
alone), so every rank runs the same batches and the ranks' collectives
pair up.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.engine.executor import make_forward, warmup_forward
from repro_torch.engine.program import CompiledNetwork
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.stats import ActivationStats
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.api import Request as ServeRequest

__all__ = ["InferenceService"]


class InferenceService:
    """Continuous-batching classification over the engine forward."""

    def __init__(
        self,
        program: CompiledNetwork,
        batch_slots: int = 8,
        collect_stats: bool = False,
        mesh=None,
        partition=None,
        max_queue: int = 0,
        clock: Callable[[], float] = time.monotonic,
        tracer: Tracer | None = None,
        device: str | torch.device | None = None,
    ):
        """``device`` is where the forward runs (``None`` means ``cuda``
        and raises when there is none; with a mesh, this rank's device of
        it).

        With ``mesh=`` every batch executes sharded: batch slots split
        over the mesh's data dim, each layer's tiles over the model dim.
        The batch shape is always the full ``batch_slots``, so the data
        dim divides it whenever ``batch_slots % data == 0``, and a
        partly filled batch shards as a full one does.  Every rank of the
        mesh's group must run the same service on the same requests, in
        the same order (module docstring).  ``partition`` is handed to
        ``make_forward`` (default: the program's).

        ``max_queue`` bounds the number of waiting requests (0 =
        unbounded); a full queue raises
        :class:`~repro_torch.engine.scheduler.SchedulerFull` from
        :meth:`submit`.

        ``tracer`` puts request lifecycles (via the scheduler) and each
        step's phases on a shared timeline: ``service.stage`` (refill,
        the slot buffer's copies, the validity mask), ``service.step``
        (the forward, which records its own ``forward`` and layer spans
        on the same tracer, then ``service.readback`` around the copy to
        the host) and ``service.complete`` (the per-slot completion
        loop).
        """
        self.program = program
        self.batch_slots = batch_slots
        self.collect_stats = collect_stats
        self.mesh = mesh
        self._forward = make_forward(
            program, collect_stats=collect_stats, mesh=mesh,
            partition=partition, tracer=tracer, device=device,
        )
        self.device = self._forward.device
        self._tracer = tracer or NULL_TRACER
        self.scheduler = SlotScheduler(
            batch_slots, max_queue=max_queue, clock=clock, tracer=tracer
        )
        shape = self._input_shape()
        # persistent slot buffer: freed slots are zeroed, so the fixed
        # batch is always "live images + zero padding"
        self._slots_x = np.zeros((batch_slots, *shape), np.float32)
        self.batches_run = 0
        self.activation_stats: ActivationStats | None = None

    def _input_shape(self) -> tuple[int, int, int]:
        cfg = self.program.config
        return (cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)

    def trace_count(self) -> int:
        """Distinct input signatures the forward has run (1 when serving
        only ever runs the fixed slot shape), traced or not."""
        return self._forward.trace_count()

    def warmup(self) -> None:
        """Run the forward once at the serving batch shape without
        sending traffic through the scheduler (metrics stay at zero)."""
        warmup_forward(self._forward, self.program, self.batch_slots)

    @property
    def metrics(self) -> dict:
        """Scheduler metrics: queue/latency/occupancy of the served load."""
        return self.scheduler.snapshot()

    def reset_stats(self) -> None:
        self.activation_stats = None

    def reset_metrics(self) -> None:
        """Start a fresh scheduler-metrics window (e.g. post warm-up)."""
        self.scheduler.reset_metrics()

    def _record_stats(self, stats: ActivationStats) -> None:
        self.activation_stats = (
            stats if self.activation_stats is None
            else self.activation_stats.merge(stats)
        )

    def _validate(self, img) -> np.ndarray:
        shape = self._input_shape()
        img = np.asarray(img, np.float32)
        if img.shape != shape:
            raise ValueError(f"request image {img.shape} != expected {shape}")
        return img

    def submit(self, request: ServeRequest) -> ServeRequest:
        """Validate and enqueue one request (raises ``SchedulerFull`` when
        the bounded queue is full, ``ValueError`` on a bad image shape)."""
        request.image = self._validate(request.image)
        self.scheduler.submit(request)
        return request

    def try_submit(self, request: ServeRequest) -> bool:
        """Validate and enqueue; ``False`` when the bounded queue is full."""
        request.image = self._validate(request.image)
        return self.scheduler.try_submit(request)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> list[ServeRequest]:
        """Refill free slots from the queue and run one fixed-shape batch.

        Returns the requests completed by this batch (empty when there
        was nothing to serve).
        """
        sched, tracer = self.scheduler, self._tracer
        with tracer.span("service.stage", cat="serve"):
            for slot, req in sched.refill():
                self._slots_x[slot] = req.image
            valid = sched.valid_mask()
        if not valid.any():
            return []
        with tracer.span(
            "service.step", cat="serve", live=int(valid.sum()),
            batch_slots=self.batch_slots,
        ):
            out = self._forward(self._slots_x, valid)
            if self.collect_stats:
                out, stats = out
                self._record_stats(stats)
            with tracer.span("service.readback", cat="serve"):
                logits = out.cpu().numpy()
        self.batches_run += 1
        with tracer.span("service.complete", cat="serve"):
            sched.record_step()
            finished = []
            for slot, req in sched.live():
                req.logits = logits[slot]
                req.label = int(np.argmax(logits[slot]))
                req.done = True
                sched.complete(slot)
                self._slots_x[slot] = 0.0  # dead slots stay zero-padded
                finished.append(req)
        return finished

    def run(self) -> list[ServeRequest]:
        """Serve until the queue and every slot are drained."""
        finished = []
        while self.scheduler.has_work():
            finished.extend(self.step())
        return finished

    def serve(self, requests: list[ServeRequest]) -> list[ServeRequest]:
        """Drain ``requests`` through the scheduler.

        All request shapes are validated before any batch runs.
        Submission interleaves with serving, so a bounded queue never
        overflows from a large one-shot batch.
        """
        images = [self._validate(r.image) for r in requests]
        for r, img in zip(requests, images):
            r.image = img
        pending = list(requests)
        while pending or self.scheduler.has_work():
            while pending and self.scheduler.has_capacity():
                self.scheduler.submit(pending.pop(0))
            self.step()
        return requests

    def classify(self, images: np.ndarray) -> np.ndarray:
        """Convenience: [N, C, H, W] -> labels [N]."""
        reqs = [ServeRequest(image=img) for img in np.asarray(images)]
        self.serve(reqs)
        return np.array([r.label for r in reqs], np.int64)

    def hardware_report(self, assumed_skip: float | None = None, **kw) -> dict:
        """Crossbar pricing from the skip statistics of the served traffic
        (``CompiledNetwork.hardware_report`` with ``skip_stats`` set to
        :attr:`activation_stats`).

        Falls back to the program's assumed/no-skip pricing when no
        requests have been served with ``collect_stats`` yet.
        """
        return self.program.hardware_report(
            skip_stats=self.activation_stats, assumed_skip=assumed_skip, **kw
        )

    def metrics_text(self) -> str:
        """Prometheus text exposition of the scheduler metrics."""
        return self.scheduler.metrics.to_prometheus(prefix="engine_service")
