"""Per-rank operation statistics of one step, from the ops it dispatches.

The port's counterpart of ``src/repro/launch/hlo_stats.py``.  The
reference parses the optimized per-device HLO of a jitted step; the port
runs eagerly, so :class:`OpStats` is a ``TorchDispatchMode`` that sees
every ATen op the step dispatches on this rank, usually over the fake
tensors of ``torch._subclasses.fake_tensor.FakeTensorMode`` (no memory
is allocated and nothing is computed), and on real tensors the same way.
It counts what ``hlo_stats`` counts:

  * ``flops``: the FLOPs of every matmul, bmm, einsum (which dispatches
    bmm) and convolution, by ``torch.utils.flop_counter``'s formulas;
  * ``bytes``: the reference's HBM proxy: the operands and results of
    those products, cache-update traffic (``index_put``, ``scatter``,
    ``gather``, ``index_copy``, ``index_select`` and the like: operands
    and result) and the step's inputs (:meth:`OpStats.add_inputs`), read
    once.  Elementwise traffic is left out, as the reference leaves it
    out for fusion;
  * collectives: every ``c10d`` op, by kind (the reference's names:
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), with its result's bytes (an all-gather's
    whole output), and those bytes by mesh dim (the dim whose group the
    op ran over, :meth:`OpStats.name_groups`);
  * ``peak_bytes``: the most bytes of storage live at once, counting the
    registered inputs, every op's new outputs and what autograd saves for
    the backward, each storage until it is freed.

The reference recovers the trip counts of ``lax.scan`` loops from the
HLO; here Python loops (the layer loop, the chunk loops) dispatch every
iteration's ops, so each is counted once per iteration and no trip count
is needed.
"""

from __future__ import annotations

import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpStats", "COLLECTIVES", "fake_mode"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (kind, index of its output in the args, index of its group)
_C10D = {
    "allgather_": ("all-gather", 0, 2),
    "_allgather_base_": ("all-gather", 0, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 2),
    "allreduce_": ("all-reduce", 0, 1),
    "allreduce_coalesced_": ("all-reduce", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 2),
    "alltoall_": ("all-to-all", 0, 2),
    "alltoall_base_": ("all-to-all", 0, 2),
    "send": ("collective-permute", 0, 1),
}

# ops whose operands and result move as cache traffic (the reference's
# dynamic-update-slice / gather / scatter)
_CACHE_OPS = frozenset((
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "gather", "index_copy", "index_copy_", "index_select", "index_add",
    "index_add_", "slice_scatter", "select_scatter",
))


def fake_mode():
    """A ``FakeTensorMode`` that takes real tensors (the statics' index
    tables) as inputs, turning each into a fake one once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class OpStats(TorchDispatchMode):
    """Count one rank's FLOPs, bytes, collectives and peak live bytes
    (module docstring).  Enter it inside the ``FakeTensorMode`` the
    step's tensors belong to (or with none, on real tensors), then read
    ``flops``, ``bytes``, ``collective_counts``,
    ``collective_bytes_by_kind``, ``collective_bytes_by_dim`` (keys
    ``"kind/dim"``) and ``peak_bytes``.  With ``keep_site``,
    ``peak_site`` is the Python stack of the allocation that last raised
    the peak (where a step's peak is set)."""

    def __init__(self, keep_site: bool = False):
        super().__init__()
        self.keep_site = keep_site
        self.peak_site = ""
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_counts: dict = defaultdict(int)
        self.collective_bytes_by_kind: dict = defaultdict(float)
        self.collective_bytes_by_dim: dict = defaultdict(float)
        self.peak_bytes = 0
        self.live_bytes = 0
        self._live: dict[int, int] = {}  # id(storage) -> bytes
        self._groups: dict[str, str] = {}  # group name -> mesh dim

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_bytes_by_kind.values()))

    def name_groups(self, mesh) -> "OpStats":
        """Attribute collectives over ``mesh``'s dims' groups to the dim
        names (a 1-D mesh's one group too)."""
        for dim in mesh.mesh_dim_names:
            self._groups[mesh.get_group(dim).group_name] = dim
        return self

    def add_inputs(self, *trees) -> "OpStats":
        """Register the step's input tensors: each storage is read once
        (``bytes``) and live from now on (``peak_bytes``)."""
        for tree in trees:
            for t in _tensors(tree):
                if self._track(t.untyped_storage()):
                    self.bytes += t.untyped_storage().nbytes()
        return self

    def _track(self, storage) -> bool:
        key = id(storage)
        if key in self._live:
            return False
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self.keep_site:
                self.peak_site = "".join(traceback.format_stack(limit=16))
        weakref.finalize(storage, self._free, key)
        return True

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _collective(self, name: str, args) -> None:
        kind, out_at, group_at = _C10D[name]
        out = _tensors(args[out_at])
        self.collective_counts[kind] += 1
        nbytes = float(sum(_nbytes(t) for t in out))
        self.collective_bytes_by_kind[kind] += nbytes
        group = args[group_at] if len(args) > group_at else None
        dim = "?"
        if isinstance(group, torch.ScriptObject):
            pg = torch.distributed.ProcessGroup.unbox(group)
            dim = self._groups.get(pg.group_name, pg.group_name)
        self.collective_bytes_by_dim[f"{kind}/{dim}"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "c10d" and name in _C10D:
            self._collective(name, args)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs, out))))
        elif name in _CACHE_OPS:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs, out))))
        for t in _tensors(out):
            self._track(t.untyped_storage())
        return out
