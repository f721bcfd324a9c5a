"""Checkpointing: atomic, hashed, async, keep-k.

The port of `repro.checkpoint.manager`, with its on-disk layout:

    <dir>/step_{N:08d}/{arrays.npz, meta.json}

A save writes into ``tmp_step_N`` and renames it (a crash mid-save never
corrupts the latest checkpoint); ``meta.json`` carries a per-file sha256
map (``files``) verified at restore, and a step that fails it is skipped
for the previous valid one.  Arrays are plain numpy keyed by tree path
with the reference's rule (`path_key`): dict keys as they are, a
NamedTuple's fields as ``.name``, sequence items by index, joined by "/"
-- so a checkpoint written by either package restores in the other.

`save` takes the host copy synchronously (a tensor on the card is copied
to numpy before `save` returns; the writer thread only ever sees numpy).
`restore` returns numpy arrays; the caller puts them on its device.
bf16 leaves are written as their raw bits (``|V2``, as `np.savez` writes
the reference's bf16 arrays) and restored as such where the template's leaf
is bf16 (`repro_torch.bridge` turns them back into bf16 tensors); a 2-byte
void leaf under a float16 template comes back as float16.

Fault site ``checkpoint.write`` (`repro_torch.testing.faults`):
``kill_mid_write`` raises after the array file lands, before the rename;
``corrupt`` flips bytes in the committed array file after its checksum.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import bridge
from ..testing import faults


def _file_digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key, child) pairs in the reference's flattening order, or None for
    a leaf: dict keys sorted, NamedTuple fields in order as ``.name``,
    sequence items by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _host_array(leaf) -> np.ndarray:
    """A numpy copy of a leaf that shares no storage with it (bf16 as its
    bits)."""
    if isinstance(leaf, torch.Tensor):
        return bridge.tensor_to_array(leaf)
    return np.array(leaf, copy=True)


def _as_template(arr: np.ndarray, template) -> np.ndarray:
    """A restored array read as the template's 2-byte float: the raw 2-byte
    bits of a bf16 leaf are float16 under a float16 template and bf16 bits
    (``|V2``) under any other; everything else as stored."""
    if not bridge.is_bf16_bits(arr.dtype):
        return arr
    if isinstance(template, torch.Tensor):
        half = template.dtype == torch.float16
    else:
        half = np.asarray(template).dtype == np.float16
    return arr.view(np.float16 if half else bridge.BF16_BITS)


def tree_to_flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """path key -> host numpy copy of every leaf."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _host_array(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in kids:
        out.update(tree_to_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def flat_to_tree(template, flat: dict[str, np.ndarray], prefix: str = ""):
    """Rebuild a tree shaped like `template` from path key -> array."""
    kids = _children(template)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(np.shape(template)):
            raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} "
                             f"vs model {tuple(np.shape(template))}")
        return _as_template(arr, template)
    built = [flat_to_tree(v, flat, f"{prefix}/{k}" if prefix else k) for k, v in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), built))
    if _is_namedtuple(template):
        return type(template)(*built)
    return type(template)(built)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ---- save ----

    def save(self, step: int, tree: Any, extra: dict | None = None, block: bool = False):
        """Copy `tree` to host numpy now; write it to disk (async by default)."""
        flat = tree_to_flat(tree)
        if self.async_save and not block:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = self.dir / f"tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        npz_path = tmp / "arrays.npz"
        with open(npz_path, "wb") as f:
            np.savez(f, **flat)
            f.flush()
        # per-file checksum map; the top-level "sha256" is the reference's
        # legacy field, kept so either package's reader accepts the step
        files = {"arrays.npz": _file_digest(npz_path)}
        meta = {"step": step, "time": time.time(),
                "sha256": files["arrays.npz"], "files": files, **extra}
        (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
        inj = faults.check("checkpoint.write", step=int(step))
        if inj is not None:
            if inj.kind == "kill_mid_write":
                # a crash between the data write and the rename: the torn
                # tmp dir stays behind, the previous step stays the latest
                raise faults.InjectedFault(f"kill_mid_write at step {step}")
            if inj.kind == "corrupt":
                # bit-rot after the checksum: the commit succeeds, restore
                # must reject it
                faults.corrupt_file(npz_path, n_bytes=int(inj.params.get("n_bytes", 64)))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore ----

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify(self, step: int) -> bool:
        """Checksum every file the step's meta lists; any missing,
        unparseable or mismatching file rejects the whole step."""
        d = self.dir / f"step_{step:08d}"
        try:
            meta = json.loads((d / "meta.json").read_text())
            files = meta.get("files") or {"arrays.npz": meta["sha256"]}
            return all(_file_digest(d / name) == want for name, want in files.items())
        except Exception:
            return False

    def restore(self, template: Any, step: int | None = None):
        """Restore into the structure of `template` (numpy arrays or
        tensors as leaves) -> (tree of numpy arrays, meta).  Without `step`,
        the newest step that verifies."""
        candidates = [step] if step is not None else list(reversed(self.all_steps()))
        for s in candidates:
            if s is None or not self._verify(s):
                continue
            with np.load(self.dir / f"step_{s:08d}" / "arrays.npz") as z:
                flat = {k: z[k] for k in z.files}
            tree = flat_to_tree(template, flat)
            meta = json.loads((self.dir / f"step_{s:08d}" / "meta.json").read_text())
            return tree, meta
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
