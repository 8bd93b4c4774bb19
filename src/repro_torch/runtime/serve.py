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
calls the step with its batch rows (``parallel.tensor.serve_rows``: its
cache slabs' rows, which the pods of a multi-pod mesh split among them),
getting its rows' next tokens.  The
step computes on the slabs, as the sharded train step does: it runs
inside ``parallel.tensor.tensor_parallel_ctx(mesh)`` and every layer
splits its heads, ``ff`` columns, experts and vocabulary over ``model``
(``models.transformer.apply_model``'s ``placed``).  What a rank gathers
is what that partitioning needs: the stream's positions where a block
reads them whole, a layer's new keys and values moved to the slabs that
hold their positions, a decode's key heads at every position for its
rows (or, with ``decode_strategy="flash"`` and no window, the query heads
to score its own slab, ``models.attention.flash_decode_placed``), MLA's
latents for its rows, an SSM's conv columns re-laid out, MoE's
per-expert counts over the row dims where capacity is the whole batch's
(``models.moe.moe_apply_tp``; else each rank's rows count their own,
as the reference's mesh counts them), the other pods' rows of what each
layer wrote of its cache slabs (``parallel.tensor.share_rows``), and the
sampled position's logits over the vocabulary; param leaves only where
no block computes on their slabs
(``parallel.tensor.slab_leaves``).  ``step.comm`` holds the last call's
bytes by kind, which ``parallel.tensor.serve_bytes`` reckons from the
shapes.  :func:`place_serving_state` cuts the whole params and cache
into a rank's slabs.

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
from repro_torch.models.attention import PlacedCache
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
    mesh_axis_sizes,
    shard_tree,
)
from repro_torch.parallel.tensor import (
    SEQ_LEAVES,
    SERVE_COMM,
    check_slabs,
    current,
    gather_pods,
    serve_comm,
    serve_pods,
    serve_row_dims,
    serve_rows,
    share_rows,
    slab_leaves,
    tensor_parallel_ctx,
)
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


class _Placed:
    """One placed step's view of the rank's slabs (``apply_model``'s
    ``placed``): the step's write position ``pos`` (already clamped as
    the cache write clamps it) and length ``s``, the leaves each block
    computes on the slabs of (``slab``), the param bytes gathered
    (``param_gather_bytes``), and the ``pods`` the rows of each cache
    slab split over (``own``: this rank's rows of a slab)."""

    def __init__(self, shardings: ServeShardings, statics, pos: int, s: int):
        self.mesh = shardings.mesh
        self.params, self.cache = shardings.params, shardings.cache
        self.batch = shardings.batch
        n = mesh_axis_sizes(self.mesh).get("model", 1)
        self.slab = slab_leaves(statics["cfg"], statics, self.params, n)
        check_slabs(self.params, self.slab)
        self.pos, self.s = pos, s
        self.param_gather_bytes = 0
        self.pods = serve_pods(self.mesh, self.batch)
        rows = self.batch // serve_rows(self.mesh, self.batch)[1]
        me = self.mesh.get_local_rank("pod") if self.pods > 1 else 0
        self.own = slice(me * rows, (me + 1) * rows)

    def _whole(self, tree, placements, slab):
        """``tree`` with each leaf no block computes on the slab of
        gathered whole."""
        def one(t, pl, on_slab):
            if on_slab or pl.whole:
                return t
            out = gather_tensor(t, pl, self.mesh)
            self.param_gather_bytes += out.numel() * out.element_size()
            return out

        return _map(one, tree, placements, slab)

    def take(self, sub: dict) -> dict:
        """Top-level entries of the params (the embedding, the head, the
        final norm, learned positions)."""
        return self._whole(sub, {k: self.params[k] for k in sub},
                           {k: self.slab[k] for k in sub})

    def _at(self, tree, where, stacked: bool = True):
        """The subtree of one layer at ``where`` (``("prefix_layers",
        i)``, ``("body", j)`` or ``("encoder", None)``) of a tree shaped
        as the params or the cache; its placements' stacked lead dropped
        with ``stacked``."""
        key, i = where
        sub = tree[key] if i is None else tree[key][i]
        return _map(_drop_lead, sub) if key != "prefix_layers" and stacked \
            else sub

    def layer_params(self, p, where):
        return self._whole(p, self._at(self.params, where),
                           self._at(self.slab, where, stacked=False))

    def layer_cache(self, c, where) -> PlacedCache:
        """One layer's cache slabs ``c`` as its blocks see them: this
        rank's rows (views, which the blocks write in place)."""
        return PlacedCache(_map(self.rows, c), self._at(self.cache, where),
                           self.pos, self.s)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a cache slab."""
        return t if self.pods == 1 else t[self.own]

    def share(self, c, where) -> None:
        """Every pod's rows of one layer's cache slabs ``c`` after the
        layer wrote its own (``parallel.tensor.share_rows``)."""
        if self.pods == 1:
            return
        tp = current()

        def walk(tree, pls):
            for k, t in tree.items():
                if isinstance(t, dict):
                    walk(t, pls[k])
                else:
                    share_rows(t, pls[k], self.pos if k in SEQ_LEAVES
                               else None, self.s, tp, self.pods)

        walk(c, self._at(self.cache, where))

    def memory(self, rows: torch.Tensor) -> torch.Tensor:
        """An encoder's output for the cache's ``memory`` slab: this
        rank's ``rows`` beside the other pods'."""
        return gather_pods(rows, current(), self.pods)


def _placed(shardings: ServeShardings | None, statics, pos: int,
            s: int) -> _Placed | None:
    """The step's :class:`_Placed`, its write position clamped to
    ``[0, T - s]`` as the cache write clamps it (``T`` the positions of
    the cache's first leaf indexed by position)."""
    if shardings is None:
        return None
    for key, at in (("prefix_layers", 1), ("body", 2)):
        t = next((pl.shape[at] for name, pl in _named_leaves(
            shardings.cache[key]) if name in SEQ_LEAVES), None)
        if t is not None:
            pos = min(max(pos, 0), t - s)
            break
    return _Placed(shardings, statics, pos, s)


@contextlib.contextmanager
def _on_slabs(placed: _Placed | None, comm: dict | None):
    """Run a step's model inside ``tensor_parallel_ctx`` over ``placed``'s
    mesh (the rows of ``serve_rows``), then set ``comm`` (its keys
    ``SERVE_COMM``) to the bytes it moved; nothing without ``placed``."""
    if placed is None:
        yield
        return
    with tensor_parallel_ctx(placed.mesh) as tp:
        tp.rows = (*serve_rows(placed.mesh, placed.batch),
                   serve_row_dims(placed.mesh, placed.batch))
        yield
    if comm is not None:
        comm.update(serve_comm(placed.param_gather_bytes, tp))


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
        placed = _placed(shardings, statics, 0, total)
        with _on_slabs(placed, prefill.comm):
            logits, cache, _ = apply_model(
                params, statics, tokens,
                positions=torch.arange(total, device=tokens.device),
                cache=cache, cache_pos=0, cache_len=total, prefill=True,
                kernels=kernels, placed=placed, **(extras or {}),
            )
        next_tok = logits[:, -1, : cfg.vocab].argmax(dim=-1)
        return next_tok, cache

    prefill.comm = dict.fromkeys(SERVE_COMM, 0)
    return prefill


def decode_logits(statics, params, cache, tokens, pos,
                  shardings: ServeShardings | None = None,
                  kernels: bool = True, comm: dict | None = None):
    """One decode step's float32 logits [B, vocab] and the cache (written
    in place at ``pos``): what :func:`make_decode_step` samples from.

    tokens: [B] last emitted; pos: the position to write — a 0-d tensor
    shared by every slot or a [B] vector of per-slot positions
    (continuous batching).  At a shared position, inside
    ``activation_sharding_ctx(mesh)`` and with ``decode_strategy=
    "flash"``, attention takes the sharded flash-decode.  With
    ``shardings`` (a shared position only) the params and cache are this
    rank's slabs and ``tokens`` its rows (module docstring); the position
    is read to the host once, and ``comm`` (a dict) gets the bytes the
    step moved (``make_decode_step``'s ``step.comm``)."""
    per_row = pos.dim() > 0
    placed = None
    if shardings is not None:
        if per_row:
            raise ValueError("a placed decode step takes one position "
                             "shared by every row")
        placed = _placed(shardings, statics, int(pos), 1)
    with _on_slabs(placed, comm):
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
                                      shardings, kernels, decode.comm)
        if scfg.temperature > 0 and rng is not None:
            probs = torch.softmax(logits / scfg.temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            next_tok = logits.argmax(dim=-1)
        return next_tok, cache

    decode.comm = dict.fromkeys(SERVE_COMM, 0)
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
