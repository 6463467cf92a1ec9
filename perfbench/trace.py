"""The traced window: ``torch.profiler`` over a run of back-to-back
steps, read into device time by kernel, busy and idle time, and the idle
gaps by what the host was doing.

Busy and idle follow ``chip_smoke.profile_run``: busy is the sum of the
device operations' own time in ``key_averages()``, and the idle share is
``1 - busy / wall``, with the wall time on the host's clock around the
window, ending in a synchronise.  A kernel is the program's own when its
name is one of the ``__global__`` functions of the program's CUDA
sources, read when the trace is read, so that a new kernel counts where
it belongs.
"""

from __future__ import annotations

import bisect
import dataclasses
import pathlib
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

__all__ = ["TraceSummary", "port_kernel_names", "kernel_base_name",
           "profile_steps", "breakdown"]

_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(\w+)\s*\(", re.S)


def port_kernel_names(csrc: pathlib.Path) -> Set[str]:
    """Names of the ``__global__`` functions defined under ``csrc``."""
    names: Set[str] = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def kernel_base_name(name: str) -> str:
    """``void repro::spmm_window_kernel<8, float>(Args)`` ->
    ``spmm_window_kernel``: the function's own name, without its
    namespace, template arguments or parameters."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(\s]", name, maxsplit=1)[0].rsplit("::", 1)[-1]


@dataclasses.dataclass
class TraceSummary:
    steps: int
    window_s: float                       # host clock, ending in a sync
    busy_s: float                         # device operations' own time
    ops: List[Tuple[str, float, int]]     # (name, seconds, count), largest first
    idle_by_host: List[Tuple[str, float]]  # idle seconds by host op

    def device_seconds(self, names: Set[str], *, inside: bool) -> float:
        """Device seconds of the kernels whose base name is (``inside``)
        or is not in ``names``."""
        return sum(s for n, s, _ in self.ops
                   if (kernel_base_name(n) in names) == inside)


def _span(ev) -> Tuple[float, float]:
    """(start, end) of a kineto event, in seconds."""
    if hasattr(ev, "start_ns"):
        start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    else:
        start, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
    return start, start + dur


def _idle_by_host(events) -> List[Tuple[str, float]]:
    """Gaps between device operations, summed by the innermost host
    operation running at each gap's middle."""
    dev, host = [], []
    for ev in events:
        a, b = _span(ev)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((a, b))
        elif b > a:
            host.append((a, b, ev.name()))
    if not dev:
        return []
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    end = dev[0][1]
    for a, b in dev[1:]:
        if a > end:
            mid = 0.5 * (a + end)
            label = "(no host op)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    label = host[j][2][:100]
                    break
            idle[label] = idle.get(label, 0.0) + (a - end)
        end = max(end, b)
    return sorted(idle.items(), key=lambda kv: -kv[1])


def _profiled(step, steps, activities, sync):
    from torch.profiler import profile

    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    return prof, window_s


HOST_TRACED_STEPS = 5


def profile_steps(step: Callable[[], object], steps: int,
                  devices: Sequence[torch.device]) -> TraceSummary:
    """Profile ``steps`` back-to-back calls of ``step`` on the devices
    alone (kernel times, busy and idle), then ``HOST_TRACED_STEPS`` more
    with the host's operations too, for the idle gaps' labels: recording
    host operations slows a host-heavy step by half, which would read as
    idle device time.  Device times are averaged over the devices."""
    from torch.profiler import ProfilerActivity

    cuda = devices[0].type == "cuda"

    def sync():
        for d in devices if cuda else ():
            torch.cuda.synchronize(d)

    dev = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    prof, window_s = _profiled(step, steps, dev, sync)
    ops = [(e.key, e.self_device_time_total * 1e-6 / len(devices), e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[1])
    busy_s = sum(o[1] for o in ops)
    idle = []
    if cuda:
        prof, _ = _profiled(step, HOST_TRACED_STEPS,
                            [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            sync)
        kineto = getattr(prof.profiler, "kineto_results", None)
        idle = _idle_by_host(kineto.events()) if kineto is not None else []
    return TraceSummary(steps, window_s, busy_s, ops, idle)


def breakdown(summary: Optional[TraceSummary]) -> Optional[dict]:
    """The result line's ``breakdown``: the ten device operations that
    took most time over the traced window, and the ten host operations
    under which the device idled longest over the host-traced steps, in
    seconds."""
    if summary is None:
        return None
    return {"device_ops": [[n[:160], s] for n, s, _ in summary.ops[:10]],
            "idle_gaps": [[n, s] for n, s in summary.idle_by_host[:10]]}
