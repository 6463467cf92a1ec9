"""One rank's step, traced op by op: the port's stand-in for XLA's cost
and memory analysis of a compiled executable.

:func:`trace_step` runs a step function once under a
``TorchDispatchMode`` that sees every aten op a rank runs.  Over a mesh
the step's operands are ``DTensor``s; the mode lets each DTensor op
through to DTensor's own dispatch (returning ``NotImplemented``) and
counts only what that dispatch runs on the rank's local tensors: the
local op and the collectives of each redistribution.  Counting the
DTensor-level op as well would add the global product to the local one,
and DTensor's sharding propagation runs each op once more on
``FakeTensor``s (made, too, by factory ops with no tensor operand), which
are skipped.  The step may run on ``meta``
tensors (any size, nothing allocated; the collectives of a ``"fake"``
process group return at once) or on real ones, and counts the same.

What is read, per rank:

  flops           ``torch.utils.flop_counter``'s formula of each local op
  bytes accessed  operand plus result bytes of each local op that is not
                  a view, an allocation or a collective (XLA's "bytes
                  accessed" sums the same per HLO op)
  collectives     ``(kind, result bytes, group size)`` of every c10d and
                  functional collective (DTensor's and the port's own
                  ``torch.distributed`` calls)
  memory          ``argument_bytes`` (the local shards of the inputs),
                  ``output_bytes``, ``alias_bytes`` (outputs that are
                  inputs updated in place: the counterpart of the
                  reference's donation) and ``temp_bytes`` (the peak of
                  the bytes the step holds beyond its arguments, less
                  its new outputs, as XLA's temporaries exclude them), so
                  ``argument + output - alias + temp`` is the rank's peak.
                  Live bytes are tracked per storage object: every
                  ``meta`` storage has ``data_ptr`` 0.
  largest         the bytes of the largest storage the step allocated
  collective      the shapes of each collective's results, in the order
  shapes          of ``collectives``
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["StepTrace", "trace_step", "local_tensor"]

# collective op name (OpOverloadPacket's) -> the reference's HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_NO_ACCESS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
              "barrier", "monitored_barrier_", "lift_fresh"}


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _flop_registry() -> Dict:
    from torch.utils import flop_counter

    return flop_counter.flop_registry


def _group_size(args, kwargs) -> int:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
    return 2          # a point-to-point send or receive: one hop


@dataclasses.dataclass
class StepTrace:
    """What one rank's traced step did (see the module docstring)."""

    flops: float
    bytes_accessed: float
    collectives: List[Tuple[str, float, int]]
    memory: Dict[str, int]
    ops: Dict[str, int]          # local aten op -> calls
    seconds: float
    largest: int = 0             # bytes of the largest storage allocated
    collective_shapes: List[List[Tuple[int, ...]]] = dataclasses.field(
        default_factory=list)

    def dump(self) -> str:
        """The trace as text, ops by count then collectives: what the
        dry-run's ``--dump-trace`` writes per cell."""
        lines = [f"# flops {self.flops:.6g}  bytes {self.bytes_accessed:.6g}"
                 f"  memory {self.memory}"]
        for name, n in sorted(self.ops.items(), key=lambda kv: -kv[1]):
            lines.append(f"{n:8d}  {name}")
        lines.append(f"# {len(self.collectives)} collectives "
                     "(kind, result bytes, group size)")
        lines.extend(f"{k}\t{b:.0f}\t{g}" for k, b, g in self.collectives)
        return "\n".join(lines) + "\n"


class _Counter(TorchDispatchMode):
    def __init__(self, arg_storages: List):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Tuple[str, float, int]] = []
        self.collective_shapes: List[List[Tuple[int, ...]]] = []
        self.largest = 0
        self.ops: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._known = WeakIdKeyDictionary()
        for st in arg_storages:
            self._known[st] = True
        self._registry = _flop_registry()

    def _free(self, n: int) -> None:
        self.live -= n

    def _allocated(self, outs: List[torch.Tensor],
                   ins: List[torch.Tensor]) -> None:
        ins_st = [t.untyped_storage() for t in ins]
        for t in outs:
            st = t.untyped_storage()
            if st in self._known or any(st is s for s in ins_st):
                continue
            self._known[st] = True
            n = st.nbytes()
            self.largest = max(self.largest, n)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor's dispatch runs the local ops
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                # DTensor's sharding propagation
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", str(packet)).split("::")[0]
        name = packet.__name__
        if ns in _COMM_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                self.collectives.append(
                    (kind, float(sum(_nbytes(t) for t in outs)),
                     _group_size(args, kwargs)))
                self.collective_shapes.append([tuple(t.shape) for t in outs])
            self._allocated(outs, ins)
            return out
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs,
                                                 out_val=out)
        if not func.is_view and name not in _NO_ACCESS:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._allocated(outs, ins)
        return out


def trace_step(fn: Callable, *args) -> Tuple[StepTrace, Any]:
    """Run ``fn(*args)`` once under the counter; returns the trace and
    ``fn``'s result.  ``args`` are the step's inputs (trees of tensors or
    DTensors): their local shards are the arguments."""
    arg_t = [local_tensor(t) for t in _tensors(args)]
    arg_st = []
    for t in arg_t:
        st = t.untyped_storage()
        if not any(st is s for s in arg_st):
            arg_st.append(st)
    counter = _Counter(arg_st)
    t0 = time.perf_counter()
    with counter:
        result = fn(*args)
    seconds = time.perf_counter() - t0
    out_t = [local_tensor(t) for t in _tensors(result)]
    out_bytes = sum(_nbytes(t) for t in out_t)
    alias = sum(_nbytes(t) for t in out_t
                if any(t.untyped_storage() is s for s in arg_st))
    memory = {
        "argument_bytes": sum(st.nbytes() for st in arg_st),
        "output_bytes": out_bytes,
        "temp_bytes": max(counter.peak - (out_bytes - alias), 0),
        "alias_bytes": alias,
    }
    return StepTrace(float(counter.flops), float(counter.bytes),
                     counter.collectives, memory, counter.ops, seconds,
                     counter.largest, counter.collective_shapes), result
