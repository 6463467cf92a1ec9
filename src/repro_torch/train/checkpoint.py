"""Checkpoint store of the training state.

Counterpart of ``repro.train.checkpoint``, in the reference's on-disk
format, so either package reads the other's checkpoints:

  * a step directory holds each leaf as raw bytes (``leaf_<i>.bin``) and a
    ``manifest.json`` mapping the leaf's key path to its ``file``,
    ``dtype`` (numpy's name; bf16 is ``"bfloat16"``) and ``shape``;
  * atomic: a step is written under ``<dir>/.tmp-<step>`` and
    ``os.replace``-d into ``step_<step>``, so a crash mid-write never
    leaves a partial step; restore reads the newest complete one;
  * bounded: all but the newest ``keep_n`` steps are pruned after a save;
  * non-blocking: ``save_async`` copies the state to the host, then writes
    on a thread while training goes on.

bf16 leaves are read back through ``torch.frombuffer``; ``None`` leaves
are skipped, as the reference's ``tree_flatten`` skips them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.pytree import leaf_paths, tree_map, unflatten

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_STEP_RE = re.compile(r"^step_(\d{10})$")
# numpy's dtype names, which the manifest holds, for the dtypes torch has
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def save_pytree(tree: Any, directory: str) -> None:
    """Write every leaf as raw bytes + a JSON manifest into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    manifest: Dict[str, Dict] = {}
    for i, (path, leaf) in enumerate(leaf_paths(tree)):
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(leaf)
        t = t.contiguous()
        fname = f"leaf_{i:05d}.bin"
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        manifest[path] = {"file": fname, "dtype": _NAMES[t.dtype],
                          "shape": list(t.shape)}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _read_leaf(directory: str, meta: Dict) -> torch.Tensor:
    if meta["dtype"] not in _DTYPES:
        raise TypeError(f"checkpoint dtype {meta['dtype']!r} has no torch "
                        "counterpart")
    dtype = _DTYPES[meta["dtype"]]
    with open(os.path.join(directory, meta["file"]), "rb") as f:
        buf = bytearray(f.read())
    if not buf:
        return torch.empty(meta["shape"], dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(meta["shape"])


def load_pytree(directory: str, like: Any) -> Any:
    """Restore a tree with the structure of ``like``.  Each leaf keeps
    the checkpoint's dtype and shape, and lands on the device of
    ``like``'s leaf where that is a tensor (else on the CPU)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for path, ref in leaf_paths(like):
        if path not in manifest:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        t = _read_leaf(directory, manifest[path])
        out.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else t)
    return unflatten(like, out)


class CheckpointManager:
    """Atomic, pruned, optionally asynchronous checkpoint directory."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- paths --

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save --

    def save(self, state: Any, step: int) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(state, tmp)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def save_async(self, state: Any, step: int) -> None:
        """Copy to the host now, write in the background (overlaps with
        training, which may then update the state in place)."""
        host_state = tree_map(lambda t: t.detach().to("cpu", copy=True),
                              state)
        self.wait()
        self._thread = threading.Thread(
            target=self._save_in_thread, args=(host_state, step), daemon=True)
        self._thread.start()

    def _save_in_thread(self, state: Any, step: int) -> None:
        try:
            self.save(state, step)
        except Exception as exc:               # noqa: BLE001 — re-raised
            self._error = exc

    def wait(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ----------------------------------------------------------- restore --

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore ``step`` (default: the latest). Returns (state, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return load_pytree(self._step_dir(step), like), step
