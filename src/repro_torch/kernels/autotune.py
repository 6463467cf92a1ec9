"""Autotuner of the hand-written kernels: route and tiles per matrix class.

Counterpart of ``repro.kernels.autotune`` (the port keeps its own copy).
FlashSparse fixes the MMA granularity (8×1 vectors), but the kernels keep
free parameters: the K-block depth ``k_blk``, the SpMM's column tile
``n_blk``, and ``split_blk``, which is also the route: 0 runs the
window-parallel kernel (``spmm_cuda``, the head grid ``spmm_batched_cuda``
for a 3-D B, ``attention_cuda``), ``>= 1`` the block-parallel kernel over
a ``Schedule`` of segments of at most ``split_blk`` K-blocks
(``spmm_balanced_cuda``, ``sddmm_balanced_cuda``,
``attention_balanced_cuda``).  The best point depends on the matrix's
structure and on N.

Each sweep times a small candidate grid per *(matrix-stats, N) bucket*
and keeps the winner in a JSON cache on disk, so later runs pay nothing.
Buckets are coarse (log2 of the window count, of the mean vectors per
window, of the window skew and of N, the structure class, the dtype, the
batch), so structurally similar matrices share an entry.  The key ends
with the device type and ``kernel`` or ``plain``: on CUDA tensors a
sweep times the kernels with CUDA events, on CPU tensors the plain
PyTorch versions with the host clock, and one never answers for the
other.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune_cache.json``; the JAX package's cache is
another file, so the two packages never share a winner.

``tune_spmm``'s ``overlap_batches`` axis (``>= 1``) times the sharded
overlap pipeline (``spmm_sharded_overlap``) at that depth over a mesh;
the mesh's data size joins the key (``|d{data}``), as the reference's.

Differences from the reference: the SDDMM kernels stream all of F through
registers, so the SDDMM sweep's ``f_blk`` candidates collapse to one
(the winner records F); and a candidate is timed on operands already at
its precision (the cast or quantization is not part of its time).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.format import (MEBCRS, BlockedMEBCRS, blocked_view,
                                     window_skew)

logger = logging.getLogger(__name__)

__all__ = [
    "TuneConfig",
    "AutotuneCache",
    "matrix_stats_key",
    "sweep_key",
    "tune_spmm",
    "tune_sddmm",
    "tune_attention",
    "default_cache",
    "reset_counters",
]

DEFAULT_K_BLKS: Tuple[int, ...] = (8, 16, 32)
DEFAULT_N_BLKS: Tuple[int, ...] = (64, 128, 256)
# split_blk candidates: 0 = the window-parallel kernel, >= 1 = the
# block-parallel kernel with that segment cap.  The skew bucket of the key
# makes the choice per matrix class.
DEFAULT_SPLIT_BLKS: Tuple[int, ...] = (0, 1)

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "autotune_cache.json")

# On-disk layout version, the reference's: v6 keys carry the structure
# class (repro_torch.sparse.structure), winners the split_blk, precision
# and overlap depth.  A file of any other schema is discarded wholesale.
SCHEMA_VERSION = 6

# What the sweeps did in this process: every candidate timed, as (stats
# key, TuneConfig with its median ms), and every candidate that failed,
# counted, with the last error.  A kernel that fails at one tile is a
# fault, and must not hide behind the winner of its sweep.
timed: List[Tuple[str, "TuneConfig"]] = []
failed_candidates = 0
last_error: Optional[str] = None


def reset_counters() -> None:
    """Forget the candidates timed and failed so far."""
    global failed_candidates, last_error
    timed.clear()
    failed_candidates, last_error = 0, None


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Winner of one sweep: the tiles, the route and the median ms.

    ``split_blk = 0`` runs the window-parallel kernel, ``>= 1`` the
    block-parallel one with that many K-blocks a segment (DESIGN.md §11).
    ``precision`` is the level the winner was timed at (``"fp32"``, the
    default, means the operands' own dtypes).  ``overlap_batches`` is the
    reference's sharded-pipeline depth, always 0 here.
    """

    k_blk: int
    n_blk: int
    median_ms: float
    split_blk: int = 0
    precision: str = "fp32"
    overlap_batches: int = 0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "TuneConfig":
        return cls(k_blk=int(d["k_blk"]), n_blk=int(d["n_blk"]),
                   median_ms=float(d["median_ms"]),
                   split_blk=int(d.get("split_blk", 0)),
                   precision=str(d.get("precision", "fp32")),
                   overlap_batches=int(d.get("overlap_batches", 0)))


def _log2_bucket(x: float) -> int:
    return max(int(x), 1).bit_length()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype (``float32``, ``bfloat16``, ``int8``)."""
    return str(dtype).replace("torch.", "")


def matrix_stats_key(fmt: MEBCRS, n: int, op: str, *, device,
                     dtype: Optional[torch.dtype] = None,
                     batch: int = 1) -> str:
    """Coarse bucket key: structurally similar (matrix, N) pairs collide.

    The bucket fields are the reference's: the vector size, log2 buckets
    of the window count, the mean vectors per window, the window skew
    (:func:`~repro_torch.core.format.window_skew`) and N, the structure
    class (:func:`~repro_torch.sparse.structure.classify_format`), the
    dense operand's dtype (by default the format's) and a log2 bucket of
    the batch (the leading head dimension).  Then the device type and
    ``kernel`` (CUDA: the kernels timed) or ``plain`` (CPU: the plain
    versions timed).
    """
    from repro_torch.sparse.structure import classify_format

    device = torch.device(device)
    w = fmt.num_windows
    avg_vec = fmt.nnzv / max(w, 1)
    dt = _dtype_name(dtype if dtype is not None else fmt.values.dtype)
    return "|".join([
        op,
        f"v{fmt.vector_size}",
        f"w{_log2_bucket(w)}",
        f"vec{_log2_bucket(avg_vec)}",
        f"sk{_log2_bucket(window_skew(fmt))}",
        f"cls{classify_format(fmt)}",
        f"n{_log2_bucket(n)}",
        f"dt{dt}",
        f"b{_log2_bucket(batch)}",
        device.type,
        "kernel" if device.type == "cuda" else "plain",
    ])


def _salvage_configs(text: str) -> Dict[str, Dict]:
    """Recover the entries of a torn or corrupted cache file.

    Entries are flat JSON objects, so every ``"key": {...}`` pair whose
    object still parses and passes :meth:`TuneConfig.from_json` is kept.
    Only when the text still carries the current schema marker (``put``
    writes it first, so a file cut at its tail keeps it): a torn file of
    another schema stays discarded.
    """
    m = re.search(r'"schema"\s*:\s*(\d+)', text)
    if m is None or int(m.group(1)) != SCHEMA_VERSION:
        return {}
    configs: Dict[str, Dict] = {}
    for em in re.finditer(r'"((?:[^"\\]|\\.)+)"\s*:\s*(\{[^{}]*\})', text):
        key = em.group(1)
        if key in ("schema", "configs"):
            continue
        try:
            entry = json.loads(em.group(2))
            TuneConfig.from_json(entry)   # reject malformed entries
        except (ValueError, KeyError, TypeError):
            continue
        configs[key] = entry
    return configs


class AutotuneCache:
    """Persistent JSON cache ``{stats_key: TuneConfig}`` with atomic saves.

    On disk: ``{"schema": SCHEMA_VERSION, "configs": {key: cfg}}``.  A file
    of another schema (or none) is treated as empty; a corrupted file of
    the current schema is salvaged entry by entry.  Saves write a
    temporary file and ``os.replace`` it; an unwritable path keeps the
    winners in memory.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(_CACHE_ENV, _DEFAULT_CACHE_PATH)
        self._data: Optional[Dict[str, Dict]] = None

    def _load(self) -> Dict[str, Dict]:
        if self._data is None:
            text = None
            try:
                with open(self.path) as f:
                    text = f.read()
                raw = json.loads(text)
                if (isinstance(raw, dict)
                        and raw.get("schema") == SCHEMA_VERSION
                        and isinstance(raw.get("configs", {}), dict)):
                    self._data = raw.get("configs", {})
                else:
                    found = (raw.get("schema", "none (v1 layout)")
                             if isinstance(raw, dict) else "none (v1 layout)")
                    logger.warning(
                        "discarding autotune cache %s: schema %s != %d "
                        "(stale bucketing; re-tuning from scratch)",
                        self.path, found, SCHEMA_VERSION)
                    self._data = {}
            except OSError:
                self._data = {}
            except ValueError:
                self._data = _salvage_configs(text or "")
                logger.warning(
                    "autotune cache %s is corrupted JSON; salvaged %d "
                    "entr%s, re-tuning the rest", self.path,
                    len(self._data), "y" if len(self._data) == 1 else "ies")
        return self._data

    def get(self, key: str) -> Optional[TuneConfig]:
        entry = self._load().get(key)
        if not entry:
            return None
        try:
            return TuneConfig.from_json(entry)
        except (KeyError, TypeError, ValueError):
            logger.warning("autotune cache %s: dropping malformed entry "
                           "for %r", self.path, key)
            return None

    def put(self, key: str, cfg: TuneConfig) -> None:
        data = self._load()
        data[key] = cfg.to_json()
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                # "schema" first: a file torn at its tail keeps the marker
                # that gates salvage
                json.dump({"schema": SCHEMA_VERSION,
                           "configs": dict(sorted(data.items()))},
                          f, indent=2)
            os.replace(tmp, self.path)
        except OSError as e:
            logger.warning("autotune cache %s is not writable (%s); "
                           "keeping tuned configs in memory only",
                           self.path, e)


_DEFAULT_CACHE: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = AutotuneCache()
    return _DEFAULT_CACHE


def _median_ms(fn, device: torch.device, reps: int, warmup: int = 1,
               batch: int = 10) -> float:
    """Median ms of one call of ``fn``.  On the card: CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``, the median over
    ``reps`` such runs after ``warmup`` calls.  On the CPU: the host clock
    around one call, the median over ``reps``."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(statistics.median(times))
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(statistics.median(times))


def sweep_key(stats_key: str, *, k_blks: Sequence[int] = DEFAULT_K_BLKS,
              n_blks: Sequence[int] = DEFAULT_N_BLKS,
              split_blks: Sequence[int] = DEFAULT_SPLIT_BLKS,
              precisions: Sequence[str] = ("fp32",),
              overlap_batches: Sequence[int] = (0,)) -> str:
    """The cache key of a sweep: the stats key and the candidate grid (a
    sweep over (8, 16) must not answer a later request for (32,))."""
    return (f"{stats_key}|k{','.join(map(str, sorted(k_blks)))}"
            f"|nb{','.join(map(str, sorted(n_blks)))}"
            f"|s{','.join(map(str, sorted(split_blks)))}"
            f"|p{','.join(sorted(precisions))}"
            f"|o{','.join(map(str, sorted(overlap_batches)))}")


def _sweep(fmt: MEBCRS, run_cfg, tile, key: str, *, device,
           k_blks: Sequence[int], n_blks: Sequence[int],
           split_blks: Sequence[int], precisions: Sequence[str],
           overlap_batches: Sequence[int] = (0,), reps: int,
           cache: Optional[AutotuneCache]) -> TuneConfig:
    """Time ``run_cfg(blocked, n_tile, split, prec, ob)`` over the
    candidate grid (``tile(n_blk)`` is the tile a candidate ``n_blk`` runs; equal
    tiles are timed once) and cache the fastest.  A candidate that raises
    is logged, counted in :data:`failed_candidates` and skipped."""
    global failed_candidates, last_error
    from repro_torch.core.quantize import validate_precision

    for prec in precisions:
        validate_precision(prec)
    cache = cache if cache is not None else default_cache()
    key = sweep_key(key, k_blks=k_blks, n_blks=n_blks, split_blks=split_blks,
                    precisions=precisions, overlap_batches=overlap_batches)
    hit = cache.get(key)
    if hit is not None:
        return hit

    best: Optional[TuneConfig] = None
    n_failed = 0
    last_exc: Optional[BaseException] = None
    for k_blk in k_blks:
        blocked = blocked_view(fmt, k_blk, device)
        for split in split_blks:
            for prec in precisions:
                for ob in overlap_batches:
                    seen = set()
                    for n_blk in n_blks:
                        eff = tile(n_blk)
                        if eff in seen:
                            continue
                        seen.add(eff)
                        # keep-alive: one candidate that fails must not end
                        # the sweep; it is counted and skipped
                        try:
                            fn = run_cfg(blocked, eff, split, prec, ob)
                            ms = _median_ms(fn, device, reps=reps)
                        except Exception as e:
                            n_failed += 1
                            failed_candidates += 1
                            last_exc = e
                            last_error = (
                                f"k_blk={k_blk}, n_blk={eff}, split={split}, "
                                f"prec={prec}, ob={ob}: {type(e).__name__}: "
                                f"{str(e)[:200]}")
                            logger.warning("autotune candidate %s failed",
                                           last_error)
                            continue
                        cand = TuneConfig(k_blk=k_blk, n_blk=eff,
                                          median_ms=ms, split_blk=split,
                                          precision=prec,
                                          overlap_batches=ob)
                        timed.append((key, cand))
                        if best is None or ms < best.median_ms:
                            best = cand
    if best is None:
        raise RuntimeError(
            f"autotune sweep for {key!r}: all {n_failed} candidates "
            f"failed") from last_exc
    cache.put(key, best)
    return best


def _at_precision(blocked: BlockedMEBCRS, b: torch.Tensor, prec: str):
    """The SpMM operands at a sweep level: ``"fp32"`` is the operands'
    own dtypes, as in the reference."""
    from repro_torch.core.spmm import apply_precision

    return (blocked, b) if prec == "fp32" else apply_precision(blocked, b,
                                                                prec)


def _cast(prec: str, *xs: torch.Tensor):
    from repro_torch.core.quantize import cast_precision

    return xs if prec == "fp32" else cast_precision(prec, *xs)


def _spmm_tile(n: int):
    """The SpMM kernels' tile for a candidate ``n_blk``: at most N rounded
    up to a warp (the kernels' own clamp)."""
    return lambda n_blk: min(n_blk, max(32, -(-n // 32) * 32))


def tune_spmm(fmt: MEBCRS, b_dense: torch.Tensor, *,
              k_blks: Sequence[int] = DEFAULT_K_BLKS,
              n_blks: Sequence[int] = DEFAULT_N_BLKS,
              split_blks: Sequence[int] = DEFAULT_SPLIT_BLKS,
              precisions: Sequence[str] = ("fp32",),
              overlap_batches: Sequence[int] = (0,), mesh=None,
              reps: int = 3,
              cache: Optional[AutotuneCache] = None) -> TuneConfig:
    """Pick ``(k_blk, n_blk, split_blk)`` for SpMM on this matrix class.

    ``split_blk = 0`` candidates time ``spmm_cuda`` (``spmm_batched_cuda``
    for a 3-D ``b_dense``, one launch for every head, the path batched
    callers run), ``>= 1`` ``spmm_balanced_cuda`` over the schedule of
    that cap.  ``precisions`` adds the dtype axis; the winner's level is
    ``TuneConfig.precision``.  ``overlap_batches`` adds the sharded
    overlap axis: candidates ``>= 1`` time ``spmm_sharded_overlap`` at
    that depth over ``mesh`` (or the ambient one), and ``0`` the
    single-device kernels.  Timed on ``b_dense``'s device.
    """
    from .spmm_balanced_cuda import spmm_balanced_cuda
    from .spmm_batched_cuda import spmm_batched_cuda
    from .spmm_cuda import spmm_cuda

    overlap = any(ob > 0 for ob in overlap_batches)
    if overlap:
        from repro_torch.distributed.ctx import _resolve_mesh

        mesh = _resolve_mesh(mesh)
    batch = b_dense.shape[0] if b_dense.dim() == 3 else 1

    def run(blocked, n_blk, split, prec, ob):
        bl, bb = _at_precision(blocked, b_dense, prec)
        if ob:
            from repro_torch.distributed.sparse_shard_overlap import (
                spmm_sharded_overlap)

            return lambda: spmm_sharded_overlap(
                bl, bb, mesh=mesh, split_blk=split, n_blk=n_blk,
                n_batches=ob)
        if split:
            sched = blocked.schedule(split)
            return lambda: spmm_balanced_cuda(bl, bb, schedule=sched,
                                              n_blk=n_blk)
        window = spmm_batched_cuda if bb.dim() == 3 else spmm_cuda
        return lambda: window(bl, bb, n_blk=n_blk)

    n = b_dense.shape[-1]
    key = matrix_stats_key(fmt, n, "spmm", device=b_dense.device,
                           dtype=b_dense.dtype, batch=batch)
    if overlap:
        from repro_torch.distributed.sparse_shard import _axis

        key = f"{key}|d{_axis(mesh, 'data')}"
    return _sweep(fmt, run, _spmm_tile(n), key, device=b_dense.device,
                  k_blks=k_blks, n_blks=n_blks, split_blks=split_blks,
                  precisions=precisions, overlap_batches=overlap_batches,
                  reps=reps, cache=cache)


def tune_sddmm(fmt: MEBCRS, q: torch.Tensor, k: torch.Tensor, *,
               k_blks: Sequence[int] = DEFAULT_K_BLKS,
               f_blks: Sequence[int] = DEFAULT_N_BLKS,
               split_blks: Sequence[int] = (0,),
               precisions: Sequence[str] = ("fp32",), reps: int = 3,
               cache: Optional[AutotuneCache] = None) -> TuneConfig:
    """Pick ``k_blk`` (and, when ``split_blks`` asks, the schedule's cap)
    for the SDDMM on this matrix class.

    The SDDMM is block-parallel already (one unit of work per K-block), so
    the sweep times ``sddmm_cuda`` only by default (``sddmm_batched_cuda``
    for 3-D Q or K); ``split_blks`` >= 1 times ``sddmm_balanced_cuda``.
    The kernels stream all of F, so ``f_blks`` (kept in the key, as the
    reference's) collapse to one candidate and the winner's ``n_blk`` is F.
    """
    from .sddmm_balanced_cuda import sddmm_balanced_cuda
    from .sddmm_batched_cuda import sddmm_batched_cuda
    from .sddmm_cuda import sddmm_cuda

    batch = next((x.shape[0] for x in (q, k) if x.dim() == 3), 1)

    def run(blocked, _f, split, prec, _ob):
        qq, kk = _cast(prec, q, k)
        if split:
            sched = blocked.schedule(split)
            return lambda: sddmm_balanced_cuda(blocked, qq, kk,
                                               schedule=sched)
        heads = qq.dim() == 3 or kk.dim() == 3
        window = sddmm_batched_cuda if heads else sddmm_cuda
        return lambda: window(blocked, qq, kk)

    f = q.shape[-1]
    key = matrix_stats_key(fmt, f, "sddmm", device=q.device, dtype=q.dtype,
                           batch=batch)
    return _sweep(fmt, run, lambda _: f, key, device=q.device, k_blks=k_blks,
                  n_blks=f_blks, split_blks=split_blks,
                  precisions=precisions, reps=reps, cache=cache)


def tune_attention(fmt: MEBCRS, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, k_blks: Sequence[int] = DEFAULT_K_BLKS,
                   split_blks: Sequence[int] = DEFAULT_SPLIT_BLKS,
                   precisions: Sequence[str] = ("fp32",), reps: int = 3,
                   cache: Optional[AutotuneCache] = None) -> TuneConfig:
    """Pick ``(k_blk, split_blk)`` for the single-pass attention:
    ``split_blk = 0`` times ``attention_cuda``, ``>= 1``
    ``attention_balanced_cuda``; ``TuneConfig.n_blk`` records the value
    width.  ``q``/``k``/``v`` may carry a leading head dimension: one
    launch for every head is timed, and H keys the bucket."""
    from .attention_balanced_cuda import attention_balanced_cuda
    from .attention_cuda import attention_cuda

    batch = next((x.shape[0] for x in (q, k, v) if x.dim() == 3), 1)
    d, dv = q.shape[-1], v.shape[-1]
    key = matrix_stats_key(fmt, d, "attn", device=q.device, dtype=q.dtype,
                           batch=batch)

    def run(blocked, _dv, split, prec, _ob):
        qq, kk, vv = _cast(prec, q, k, v)
        if split:
            sched = blocked.schedule(split)
            return lambda: attention_balanced_cuda(blocked, qq, kk, vv,
                                                   schedule=sched)
        return lambda: attention_cuda(blocked, qq, kk, vv)

    return _sweep(fmt, run, lambda n_blk: n_blk, key, device=q.device,
                  k_blks=k_blks, n_blks=(dv,), split_blks=split_blks,
                  precisions=precisions, reps=reps, cache=cache)
