"""Async, atomic checkpointing of nested dict/list trees of tensors.

Port of ``repro.distributed.checkpoint`` in its format:

* one ``.npy`` per leaf under ``step_<n>/``, named by the leaf's tree
  path joined with ``__`` (``layers__0__attn__wq__w``; the JAX package's
  ``_path_key``), beside a ``MANIFEST.json`` holding each leaf's shape,
  dtype and the first 16 hex digits of the file's sha256;
* a bfloat16 leaf (numpy has none) is written as its 16-bit words with
  the ``<V2`` descriptor that JAX's ``np.save`` gives an ``ml_dtypes``
  bfloat16 array, under ``"dtype": "bfloat16"`` in the manifest: the
  same file bytes, so the same checksum, as JAX writes for the same
  values, and restore views the words back;
* **atomic**: leaves go to ``step_<n>.tmp``, which is renamed to
  ``step_<n>`` once its manifest is written; a directory without a
  manifest is never listed;
* **async**: ``save(..., blocking=False)`` copies every leaf to host
  memory before its writer thread starts (a CPU leaf is cloned, since
  ``.cpu()`` of a CPU tensor is the same storage and an in-place
  optimizer step would race the writer) and ``wait()`` re-raises what
  the writer raised;
* **retention**: the newest ``keep`` checkpoints stay.

Restore takes the ``shardings`` parameter of the JAX version and raises
for any value but ``None``: ``distributed.sharding`` is not ported.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, unflatten_like

_BF16_DESCR = "<V2"       # what np.save writes for an ml_dtypes bfloat16


def _path_key(path) -> str:
    return "__".join(str(k) for k in path) or "root"


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of ``leaf`` that no later in-place update can touch."""
    return leaf.detach().to("cpu", copy=True,
                            memory_format=torch.contiguous_format)


def _sha16(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()[:16]


def _save_leaf(fn: Path, leaf: torch.Tensor) -> tuple:
    """Write one leaf; returns (shape, manifest dtype name)."""
    if leaf.dtype == torch.bfloat16:
        words = leaf.view(torch.int16).numpy()
        with open(fn, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(words.shape)})
            f.write(words.tobytes())
        return list(words.shape), "bfloat16"
    arr = leaf.numpy()
    np.save(fn, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(fn: Path, dtype_name: str) -> torch.Tensor:
    arr = np.load(fn)
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{fn.name}: bfloat16 leaf with "
                             f"{arr.dtype.itemsize}-byte items")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        host = [(path, _snapshot(leaf))
                for path, leaf in leaves_with_path(tree)]
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree: Any) -> None:
        self.save(step, tree, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, host: list) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for path, leaf in host:
            key = _path_key(path)
            fn = tmp / f"{key}.npy"
            shape, dtype = _save_leaf(fn, leaf)
            manifest["leaves"][key] = {"shape": shape, "dtype": dtype,
                                       "sha256": _sha16(fn)}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        if not self.dir.exists():
            return out
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "MANIFEST.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None, *,
                device=None) -> Any:
        """A tree of ``like``'s structure (tensors; ``meta`` ones will do)
        holding checkpoint ``step``, each leaf cast to its ``like`` leaf's
        dtype and placed on ``device`` (default: that leaf's device)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...): distributed.sharding is not "
                "ported to repro_torch; restore onto one device")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        out = []
        for path, leaf in leaves_with_path(like):
            key = _path_key(path)
            if key not in manifest["leaves"]:
                raise KeyError(f"checkpoint missing leaf {key}")
            want = manifest["leaves"][key]
            t = _load_leaf(d / f"{key}.npy", want["dtype"])
            if list(t.shape) != want["shape"]:
                raise ValueError(f"corrupt leaf {key}")
            dev = device if device is not None else leaf.device
            if torch.device(dev).type == "meta":
                raise ValueError("restore onto meta tensors: pass device=")
            out.append(t.to(device=dev, dtype=leaf.dtype))
        return unflatten_like(like, out)
