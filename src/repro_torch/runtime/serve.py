"""Serving runtime: prefill + decode steps and continuous-batching decode.

Port of ``src/repro/runtime/serve.py``.  ``make_prefill_step`` /
``make_decode_step`` build the step functions: one prompt's prefill, and
one new token per row against a KV cache of ``max_seq``.  The caches are
updated in place.

**Placed** (``shardings=`` a :class:`ServeShardings` over a
``DeviceMesh``, the reference's production serving steps,
``launch/steps.py``): every rank holds only its slabs, the params' by
``launch.steps.param_shardings`` and the caches' by
``launch.steps.cache_shardings`` (batch over ``data``, positions over
``model``, an SSM's conv over ``ff`` and its state over ``heads``), and
calls the step with its batch rows (over ``pod`` and ``data``, pod-major,
where they divide the batch; else every row), getting its rows' next
tokens.  Storage split, compute gathered, as the sharded train step
does (``models.transformer.apply_model``'s ``placed``): each layer's
param and cache slabs are all-gathered just before it runs, it computes
on the rank's rows, and its new cache entries (the positions written,
or an SSM's whole state) are gathered over the rows and cut back to
each rank's slab.  It is exact by construction, and a rank's peak is
its slabs plus one layer whole.  With ``decode_strategy="flash"`` a
decode's attention layers without a window gather no key or value:
``models.attention.flash_decode_placed`` reads the rank's slab.
:func:`place_serving_state` cuts the whole params and cache into a
rank's slabs.

:class:`DecodeService` is the continuous-batching generation backend:
per-slot decode positions (``pos [batch_slots]``) let the shared
:class:`~repro_torch.engine.scheduler.SlotScheduler` admit a queued prompt
into a freed slot *while the other slots are mid-decode*, with all
per-request state (prompt lengths, emitted counts, completion) host-side
in the scheduler and only fixed-shape tensors (``tokens [B]``,
``pos [B]``, the batched cache) reaching the model:

  * the decode step always runs at the fixed ``[batch_slots]`` shape:
    the port runs eagerly and :meth:`DecodeService.trace_count` counts
    the distinct input signatures decode has run, which stays 1; dead
    slots decode at position 0 into cache rows that the next admission
    overwrites;
  * admission prefills the prompt at its exact length on a fresh
    single-row cache and copies that row into the batched cache
    (``make_slot_prefill``) — exact for recurrent SSM state too, where a
    padded batch prefill would fold pad garbage into the state; prefill
    takes the flash-attention kernel on the card
    (``models/attention.py``), and
    :meth:`DecodeService.prefill_trace_count` counts the distinct prompt
    lengths;
  * a request's tokens are bit-identical co-batched or solo: every
    per-row op (masked attention, the SSM scan, the MLP, sampling) is
    independent across batch rows (MoE's capacity is not: it counts the
    batch's tokens, as the reference's does).

:class:`ServeLoop` keeps the drain-a-list-of-requests API on top of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.models.attention import PlacedKV
from repro_torch.models.moe import rows_over_data
from repro_torch.models.transformer import (
    ModelConfig,
    _leaves,
    apply_model,
    init_cache,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.parallel.sharding import (
    Placement,
    _map,
    _shape,
    gather_tensor,
    shard_tensor,
    shard_tree,
)
from repro_torch.parallel.tensor import data_shards, gather_over_data
from repro_torch.serve.api import Request as ServeRequest

__all__ = [
    "ServeConfig",
    "ServeShardings",
    "serve_shardings",
    "place_serving_state",
    "make_prefill_step",
    "decode_logits",
    "make_decode_step",
    "make_slot_prefill",
    "DecodeService",
    "ServeLoop",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 1024
    temperature: float = 0.0  # 0 -> greedy
    eos_id: int = 0
    cache_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ServeShardings:
    """Where each rank of ``mesh`` keeps its share of a serving state:
    ``params`` and ``cache``, trees of ``parallel.sharding.Placement``,
    and the cache's ``batch`` rows."""

    mesh: object
    params: object
    cache: object
    batch: int


def _cache_batch(cache) -> int:
    """The batch rows of a cache tree (of tensors or placements): a prefix
    layer's or the memory's first dim, else a stacked leaf's second."""
    if "memory" in cache:
        return _shape(cache["memory"])[0]
    if cache["prefix_layers"]:
        return _shape(next(_leaves(cache["prefix_layers"])))[0]
    return _shape(next(_leaves(cache["body"])))[1]


def _named_leaves(tree, name: str = ""):
    """(key, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def serve_shardings(specs, params, cache, mesh) -> ServeShardings:
    """The placements of a serving state on ``mesh``: the params' from
    their logical specs (``models.transformer.init_specs``) and shapes,
    the cache's from its leaves (tensors or shapes)."""
    from repro_torch.launch.steps import cache_shardings, param_shardings

    return ServeShardings(mesh, param_shardings(specs, params, mesh),
                          cache_shardings(cache, mesh), _cache_batch(cache))


def place_serving_state(params, cache, shardings: ServeShardings):
    """This rank's slabs of the whole ``params`` and ``cache``."""
    return (shard_tree(params, shardings.params),
            shard_tree(cache, shardings.cache))


def _drop_lead(pl: Placement) -> Placement:
    """One layer's placement within a stacked leaf's (its leading dim,
    which no mesh axis splits, dropped)."""
    return Placement(pl.shape[1:], pl.pspec[1:], pl.blocks[1:], pl.index[1:])


# cache leaves indexed by position: a step rewrites only the positions it
# writes
_SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")


class _Placed:
    """One placed step's view of the rank's slabs (``apply_model``'s
    ``placed``): the rank's compute rows, the step's write position
    ``pos`` (already clamped as the cache write clamps it) and length
    ``s``, and whether a decode's attention reads its cache slab
    (``flash``)."""

    def __init__(self, shardings: ServeShardings, pos: int, s: int,
                 flash: bool):
        self.mesh = shardings.mesh
        self.params, self.cache = shardings.params, shardings.cache
        r, n = data_shards(self.mesh)
        self.split = n > 1 and shardings.batch % n == 0
        r, n = (r, n) if self.split else (0, 1)
        per = shardings.batch // n
        self.rows = slice(r * per, (r + 1) * per)
        self.pos, self.s, self.flash = pos, s, flash

    def moe_rows(self):
        """The context a layer runs in: MoE capacity over the whole batch
        where the ranks split its rows (``models.moe.rows_over_data``)."""
        return rows_over_data(self.mesh) if self.split else \
            contextlib.nullcontext()

    def gather(self, tree, placements):
        """Whole leaves from this rank's slabs."""
        return _map(lambda t, pl: gather_tensor(t, pl, self.mesh), tree,
                    placements)

    def stacked(self, key: str, j: int | None = None, tree=None):
        """The one-layer placements of a stacked subtree: ``key`` of
        ``tree`` (default: the params'), its ``j``-th entry for a list."""
        tree = self.params if tree is None else tree
        return _map(_drop_lead, tree[key] if j is None else tree[key][j])

    def layer(self, where):
        """(param placements, cache placements) of the layer at ``where``
        (``("prefix_layers", i)`` or ``("body", j)``)."""
        key, i = where
        if key == "prefix_layers":
            return self.params[key][i], self.cache[key][i]
        return self.stacked(key, i), self.stacked(key, i, self.cache)

    def to_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows from every rank's compute rows."""
        return gather_over_data(self.mesh, t).flatten(0, 1) if self.split \
            else t

    def rows_of(self, slab: torch.Tensor, pl: Placement) -> torch.Tensor:
        """This rank's compute rows of a leaf, gathered whole from its
        slabs."""
        return gather_tensor(slab, pl, self.mesh)[self.rows]

    def cut(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """This rank's slab of a leaf of which every rank computed its
        rows ``t``."""
        return shard_tensor(self.to_batch(t), pl)

    def layer_cache(self, static: dict, slabs, placements):
        """The cache a layer computes with: its leaves gathered whole and
        cut to the compute rows, or, for a flash decode's attention, the
        slabs themselves (``PlacedKV``)."""
        if slabs is None:
            return None
        cfg = static.get("attn_cfg")
        flash = (self.flash and self.s == 1 and cfg is not None
                 and cfg.window is None)

        def walk(tree, pl):
            if isinstance(tree, dict):
                if flash and set(tree) == {"k", "v"}:
                    return PlacedKV(tree, pl, self)
                return {k: walk(v, pl[k]) for k, v in tree.items()}
            return self.rows_of(tree, pl)

        return walk(slabs, placements)

    def write_seq(self, slab: torch.Tensor, pl: Placement,
                  new: torch.Tensor) -> None:
        """Write the whole batch's ``new`` [B, s, ...], the positions
        ``[pos, pos + s)``, into the part of them this rank's slab
        holds."""
        rows, seq = pl.slices[0], pl.slices[1]
        lo, hi = max(self.pos, seq.start), min(self.pos + self.s, seq.stop)
        if lo < hi:
            slab[:, lo - seq.start:hi - seq.start] = new[
                rows, lo - self.pos:hi - self.pos].to(slab.dtype)

    def store(self, run, slabs, placements, name: str = "") -> None:
        """Cut a layer's new cache entries (``run``, what it computed
        with) back to this rank's slabs."""
        if run is None or isinstance(run, PlacedKV):
            return
        if isinstance(run, dict):
            for k in run:
                self.store(run[k], slabs[k], placements[k], k)
        elif name in _SEQ_LEAVES:
            new = run[:, self.pos:self.pos + self.s]
            self.write_seq(slabs, placements, self.to_batch(new))
        else:
            slabs.copy_(shard_tensor(self.to_batch(run), placements))


def _placed(shardings: ServeShardings | None, pos: int, s: int,
            flash: bool) -> _Placed | None:
    """The step's :class:`_Placed`, its write position clamped to
    ``[0, T - s]`` as the cache write clamps it (``T`` the positions of
    the cache's first leaf indexed by position)."""
    if shardings is None:
        return None
    for key, at in (("prefix_layers", 1), ("body", 2)):
        t = next((pl.shape[at] for name, pl in _named_leaves(
            shardings.cache[key]) if name in _SEQ_LEAVES), None)
        if t is not None:
            pos = min(max(pos, 0), t - s)
            break
    return _Placed(shardings, pos, s, flash)


def make_prefill_step(cfg: ModelConfig, statics, scfg: ServeConfig,
                      shardings: ServeShardings | None = None,
                      kernels: bool = True):
    def prefill(params, cache, tokens, extras=None):
        """tokens: [B, S] -> (next_token [B], cache).  ``extras`` go to
        ``apply_model``: an encoder-decoder's stub frame embeddings
        (``extras['frames']`` [B, enc_seq, d]) are encoded and their
        output kept as the cache's ``memory``, which the decode steps
        read (this is how whisper is served: ``DecodeService`` encodes no
        frames, as the reference's does not).  A VLM patch prefix
        (``extras['prefix_embeds']`` [B, P, d]) extends the context:
        positions and the cache length cover P + S, so decoding goes on
        at position P + S (paligemma is served so: ``DecodeService``
        takes no prefix, as the reference's takes none).  With
        ``shardings`` the params and cache are this rank's slabs and
        ``tokens`` and ``extras`` its rows (module docstring); with
        ``kernels=False`` every layer takes its plain route."""
        total = tokens.shape[1]
        if extras and "prefix_embeds" in extras:
            total += extras["prefix_embeds"].shape[1]
        logits, cache, _ = apply_model(
            params, statics, tokens,
            positions=torch.arange(total, device=tokens.device),
            cache=cache, cache_pos=0, cache_len=total, prefill=True,
            kernels=kernels,
            placed=_placed(shardings, 0, total, False),
            **(extras or {}),
        )
        next_tok = logits[:, -1, : cfg.vocab].argmax(dim=-1)
        return next_tok, cache

    return prefill


def decode_logits(statics, params, cache, tokens, pos,
                  shardings: ServeShardings | None = None,
                  kernels: bool = True):
    """One decode step's float32 logits [B, vocab] and the cache (written
    in place at ``pos``): what :func:`make_decode_step` samples from.

    tokens: [B] last emitted; pos: the position to write — a 0-d tensor
    shared by every slot or a [B] vector of per-slot positions
    (continuous batching).  At a shared position, inside
    ``activation_sharding_ctx(mesh)`` and with ``decode_strategy=
    "flash"``, attention takes the sharded flash-decode.  With
    ``shardings`` (a shared position only) the params and cache are this
    rank's slabs and ``tokens`` its rows (module docstring); the position
    is read to the host once."""
    per_row = pos.dim() > 0
    placed = None
    if shardings is not None:
        if per_row:
            raise ValueError("a placed decode step takes one position "
                             "shared by every row")
        placed = _placed(shardings, int(pos), 1,
                         statics["cfg"].decode_strategy == "flash")
    logits, cache, _ = apply_model(
        params, statics, tokens[:, None],
        positions=pos[:, None] if per_row else pos[None],
        cache=cache, cache_pos=pos, cache_len=pos + 1, kernels=kernels,
        placed=placed,
    )
    return logits[:, -1, : statics["cfg"].vocab].float(), cache


def make_decode_step(cfg: ModelConfig, statics, scfg: ServeConfig,
                     shardings: ServeShardings | None = None,
                     kernels: bool = True):
    def decode(params, cache, tokens, pos, rng: torch.Generator | None = None):
        """tokens: [B] last emitted; pos: the position to write (see
        :func:`decode_logits`, which takes ``shardings`` and
        ``kernels``).  With ``temperature > 0`` and a generator,
        samples; else greedy."""
        logits, cache = decode_logits(statics, params, cache, tokens, pos,
                                      shardings, kernels)
        if scfg.temperature > 0 and rng is not None:
            probs = torch.softmax(logits / scfg.temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            next_tok = logits.argmax(dim=-1)
        return next_tok, cache

    return decode


def _scatter_cache_row(batch_cache, row_cache, slot: int):
    """Write the single-row ``row_cache`` into row ``slot`` of the batched
    cache, in place, cast to the batched cache's dtypes.  Prefix layers
    and the encoder memory carry batch on axis 0; the stacked body
    carries periods in front, so batch sits on axis 1."""
    for dst, src in zip(_leaves(batch_cache["prefix_layers"]),
                        _leaves(row_cache["prefix_layers"])):
        dst[slot:slot + 1].copy_(src)
    for dst, src in zip(_leaves(batch_cache["body"]),
                        _leaves(row_cache["body"])):
        dst[:, slot:slot + 1].copy_(src)
    if "memory" in batch_cache:
        batch_cache["memory"][slot:slot + 1].copy_(row_cache["memory"])
    return batch_cache


def make_slot_prefill(cfg: ModelConfig, statics, scfg: ServeConfig):
    cache_dtype = getattr(torch, scfg.cache_dtype)

    def prefill(params, caches, tokens, slot: int):
        """tokens: [1, L] exact-length prompt; slot: slot index.

        Prefills a fresh single-row cache at the prompt's exact length —
        no padding — then copies the row into the batched cache at
        ``slot``.  Returns (first sampled token [], updated caches)."""
        length = tokens.shape[1]
        row = init_cache(statics, 1, scfg.max_seq, dtype=cache_dtype,
                         device=tokens.device)
        logits, row, _ = apply_model(
            params, statics, tokens,
            positions=torch.arange(length, device=tokens.device),
            cache=row, cache_pos=0, cache_len=length, prefill=True,
        )
        caches = _scatter_cache_row(caches, row, slot)
        return logits[0, -1, : cfg.vocab].argmax(), caches

    return prefill


class DecodeService:
    """Continuous-batching token generation over per-slot decode positions.

    Speaks the same step-based verb set as
    ``engine.service.InferenceService`` — ``submit``/``try_submit`` to
    enqueue a :class:`repro_torch.serve.api.Request` (``prompt`` set),
    ``step()`` to admit + advance one decode step, ``run()`` to drain — so
    the ``serve.session`` facade and the HTTP server drive either backend
    identically.  ``params`` live on ``device`` (``None``: ``cuda``,
    raising without one).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        statics,
        params,
        scfg: ServeConfig,
        max_queue: int = 0,
        clock: Callable[[], float] = time.monotonic,
        tracer: Tracer | None = None,
        capture_logits: bool = False,
        device=None,
    ):
        self.cfg, self.statics, self.scfg = cfg, statics, scfg
        self.params = params
        self.device = resolve_device(device)
        self._tracer = tracer or NULL_TRACER
        self.scheduler = SlotScheduler(
            scfg.batch_slots, max_queue=max_queue, clock=clock, tracer=tracer
        )
        self.caches = init_cache(
            statics, scfg.batch_slots, scfg.max_seq,
            dtype=getattr(torch, scfg.cache_dtype), device=self.device,
        )
        self._decode_signatures: set = set()
        self._prefill_lengths: set = set()
        self._decode_fn = make_decode_step(cfg, statics, scfg)
        self._prefill_fn = make_slot_prefill(cfg, statics, scfg)
        self.capture_logits = capture_logits
        self._tokens = np.zeros(scfg.batch_slots, np.int64)
        self._pos = np.zeros(scfg.batch_slots, np.int64)
        self.last_logits: np.ndarray | None = None  # capture_logits only
        self.steps_run = 0

    # ------------------------------------------------------------ admission

    def trace_count(self) -> int:
        """Distinct input signatures the fixed-shape decode step has run
        (the single-trace invariant: 1 for any traffic pattern)."""
        return len(self._decode_signatures)

    def prefill_trace_count(self) -> int:
        """Distinct prompt lengths prefilled."""
        return len(self._prefill_lengths)

    @property
    def metrics(self) -> dict:
        return self.scheduler.snapshot()

    def metrics_text(self) -> str:
        return self.scheduler.metrics.to_prometheus(prefix="decode_service")

    def reset_metrics(self) -> None:
        self.scheduler.reset_metrics()

    def _validate(self, request: ServeRequest) -> ServeRequest:
        if request.prompt is None:
            raise ValueError("generation request needs a prompt")
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size < 1 or prompt.size > self.scfg.max_seq:
            raise ValueError(
                f"prompt length {prompt.size} outside [1, "
                f"{self.scfg.max_seq}]"
            )
        request.prompt = prompt
        return request

    def submit(self, request: ServeRequest) -> ServeRequest:
        """Validate + enqueue (raises ``SchedulerFull`` when bounded
        queue is full — front ends should use ``try_submit``)."""
        self.scheduler.submit(self._validate(request))
        return request

    def try_submit(self, request: ServeRequest) -> bool:
        return self.scheduler.try_submit(self._validate(request))

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------- stepping

    def _finish(self, slot: int, req: ServeRequest, finished: list) -> None:
        req.done = True
        self.scheduler.complete(slot)
        self._tokens[slot] = 0
        self._pos[slot] = 0
        finished.append(req)

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor):
        self._decode_signatures.add(
            (tuple(tokens.shape), tokens.dtype, tuple(pos.shape), pos.dtype))
        if not self.capture_logits:
            tok, self.caches = self._decode_fn(self.params, self.caches,
                                               tokens, pos)
            return tok, None
        # debug/test variant: also return the [B, vocab] decode logits
        logits, self.caches, _ = apply_model(
            self.params, self.statics, tokens[:, None],
            positions=pos[:, None], cache=self.caches, cache_pos=pos,
            cache_len=pos + 1,
        )
        logits = logits[:, -1, : self.cfg.vocab].float()
        return logits.argmax(dim=-1), logits

    @torch.no_grad()
    def step(self) -> list[ServeRequest]:
        """Admit queued prompts into free slots (prefill), then advance
        every live slot one decode step at its own position.  Returns the
        requests completed by this step."""
        sched = self.scheduler
        scfg = self.scfg
        finished: list[ServeRequest] = []
        was_decoding = bool(sched.live())
        for slot, req in sched.refill():
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                     device=self.device)
            length = prompt.shape[1]
            with self._tracer.span(
                "serve.prefill", cat="serve", slot=slot, len=length
            ):
                self._prefill_lengths.add(length)
                tok, self.caches = self._prefill_fn(
                    self.params, self.caches, prompt, slot)
                t = int(tok)
            req.output.append(t)
            self._tokens[slot] = t
            self._pos[slot] = length
            sched.record_first_result(slot)
            if was_decoding:
                # the mid-decode admission instant: this slot was refilled
                # while other slots were already between decode steps
                self._tracer.async_instant(
                    "request", sched.slot_rid(slot), cat="request",
                    event="admit_mid_decode", slot=slot, pos=int(length),
                )
            if (
                t == scfg.eos_id
                or len(req.output) >= req.max_new_tokens
                or self._pos[slot] >= scfg.max_seq
            ):
                self._finish(slot, req, finished)
        live = sched.live()
        if not live:
            return finished
        with self._tracer.span("serve.decode", cat="serve", live=len(live)):
            tok, logits = self._decode(
                torch.as_tensor(self._tokens, device=self.device),
                torch.as_tensor(self._pos, device=self.device),
            )
            tok_np = tok.cpu().numpy()
            if logits is not None:
                self.last_logits = logits.cpu().numpy()
        self.steps_run += 1
        sched.record_step()
        for slot, req in live:
            t = int(tok_np[slot])
            self._tokens[slot] = t
            self._pos[slot] += 1
            req.output.append(t)
            if (
                t == scfg.eos_id
                or len(req.output) >= req.max_new_tokens
                or self._pos[slot] >= scfg.max_seq
            ):
                self._finish(slot, req, finished)
        return finished

    def run(self) -> list[ServeRequest]:
        """Serve until the queue and every slot are drained."""
        finished: list[ServeRequest] = []
        while self.has_work():
            finished.extend(self.step())
        return finished


class ServeLoop:
    """Drain-a-list-of-requests wrapper over :class:`DecodeService`.

    Admission is continuous: a freed slot refills from the queue on the
    very next step while the remaining slots keep decoding at their own
    per-slot positions.  ``loop.metrics`` carries the scheduler snapshot
    after :meth:`generate`.
    """

    def __init__(self, cfg: ModelConfig, statics, params, scfg: ServeConfig,
                 tracer: Tracer | None = None, device=None):
        self.cfg, self.statics, self.scfg = cfg, statics, scfg
        self.params = params
        self.tracer = tracer or NULL_TRACER
        self.service = DecodeService(
            cfg, statics, params, scfg, tracer=tracer, device=device
        )
        self.metrics: dict | None = None

    def generate(self, requests: list[ServeRequest]) -> list[ServeRequest]:
        for r in requests:
            self.service.submit(r)
        self.service.run()
        self.metrics = self.service.scheduler.snapshot()
        return requests
