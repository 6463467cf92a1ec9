"""Re-export of the ring-overlap matmul, which lives in
:mod:`repro_torch.distributed.overlap` (counterpart of
``repro.distributed.collective_matmul``, the reference's shim)."""

from __future__ import annotations

from .overlap import collective_matmul, ring_allgather_matmul

__all__ = ["ring_allgather_matmul", "collective_matmul"]
