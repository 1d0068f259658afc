"""Fault-tolerant checkpoints: atomic, asynchronous, keep-k, elastic (twin
of ``repro.checkpoint.manager``).

The files are the reference's, byte for byte in layout, so either package
restores what the other saved: ``<dir>/step_NNNNNNNNNN/arrays.npz`` holds
one array per leaf under the ``/``-joined path of its dict keys and list
indices (``arena/l0/k_bitmap``, ``hashes``), beside ``manifest.json``.

* **atomicity**: a checkpoint is staged under ``.tmp-<step>`` and
  ``os.rename``\\ d into place; a crash mid-save leaves only a tmp
  directory, which the next manager garbage-collects.
* **async**: :meth:`CheckpointManager.save` copies every leaf to host
  memory first (the device-to-host copies happen in the caller), then one
  background thread writes, so the caller may go on changing its tensors
  in place at once.
* **keep-k + manifest**: ``manifest.json`` records the step, the time and
  the caller's metadata; older checkpoints are pruned once the newer one
  is durable.
* **on a mesh** (``shardings=(spec tree, mesh)``): :meth:`save` gathers
  each leaf's blocks from every rank, one leaf at a time, and rank 0
  writes the full tree; :meth:`restore` cuts each rank's block of each
  leaf as it reads it, on any mesh (elastic: the file holds the full
  tree, so a checkpoint of one mesh restores onto another).

Two dtypes need care between the packages.  numpy has no bf16: the
reference writes ml_dtypes bf16, which ``np.load`` returns as 2-byte void
(``V2``), so the port writes its bf16 tensors as ``V2`` too and reads bf16
back from ``V2``, ``uint16`` or ml_dtypes bf16 by reinterpreting the bits.
Bitmap words are ``uint32`` in the reference and int32 bit-views in the
port: a restore crosses integer kinds of one size with a view, never a
value cast.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import gather_tree, local_slices


def _host(leaf: Any) -> np.ndarray:
    """A host copy of one leaf (a tensor on any device, an array or a
    scalar); bf16 tensors become ``V2`` arrays of the same bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _walk(tree: Any, prefix: str = ""):
    """``(key, leaf)`` for every leaf of nested dicts and lists, keyed as
    the reference keys them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _walk(tree)}


def _gathered_host(tree: Any, specs: Any, mesh, keep: bool,
                   prefix: str = "") -> Dict[str, np.ndarray]:
    """Every leaf of a placed ``tree`` gathered whole over ``mesh`` (each
    rank takes part in every gather), kept as host arrays only where
    ``keep``; one full leaf at a time is on the device."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_gathered_host(v, None if specs is None else specs[k],
                                      mesh, keep,
                                      f"{prefix}/{k}" if prefix else str(k)))
        return out
    full = tree if specs is None else gather_tree(tree, specs, mesh)
    return {prefix: _host(full)} if keep else {}


def _bits16(arr: np.ndarray) -> Optional[np.ndarray]:
    """The uint16 bits of a 2-byte array that may hold bf16 (``V2``,
    ml_dtypes bf16, ``uint16``, ``int16``), else None."""
    if arr.dtype.itemsize == 2 and (arr.dtype.kind in "Vui"
                                    or arr.dtype.name == "bfloat16"):
        return arr.view(np.uint16)
    return None


def _as(arr: np.ndarray, want: np.dtype) -> np.ndarray:
    """``arr`` in numpy dtype ``want``: same-size integers (the reference's
    uint32 bitmap words, the port's int32 bit-views) and void bytes are
    reinterpreted, anything else converted."""
    if arr.dtype == want:
        return arr
    if arr.dtype.itemsize == want.itemsize and (
            arr.dtype.kind == "V" or (arr.dtype.kind in "ui"
                                      and want.kind in "ui")):
        return arr.view(want)
    return arr.astype(want)


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        bits = _bits16(arr)
        if bits is not None:
            return torch.from_numpy(np.array(bits)).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr, np.float32)).to(dtype)
    want = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.array(_as(arr, want)))


def _unflatten_into(tree: Any, arrays: Dict[str, np.ndarray],
                    prefix: str = "", specs: Any = None, mesh=None) -> Any:
    """A tree shaped like ``tree`` with each leaf read from ``arrays``:
    torch leaves come back as CPU tensors of the leaf's dtype, numpy (or
    anything with a ``dtype``) as arrays of that dtype, other leaves as
    stored; with ``specs`` (a matching spec tree, None leaves whole) each
    torch leaf is cut to this rank's block of ``mesh`` as it is read.
    Raises a readable ``ValueError`` naming the first missing or
    misshapen leaf."""
    sub = lambda k: None if specs is None else specs[k]
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, arrays, f"{prefix}/{k}" if prefix
                                   else str(k), sub(k), mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten_into(v, arrays, f"{prefix}/{i}" if prefix
                               else str(i), sub(i), mesh)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    key = prefix
    if key not in arrays:
        raise ValueError(
            f"checkpoint missing array {key!r}: the saved tree does not "
            f"match the restore template (has "
            f"{sorted(arrays)[:8]}{'...' if len(arrays) > 8 else ''})")
    arr = arrays[key]
    want_shape = getattr(tree, "shape", None)
    if want_shape is not None and tuple(arr.shape) != tuple(want_shape):
        raise ValueError(
            f"checkpoint geometry mismatch at {key!r}: restore template "
            f"expects shape {tuple(want_shape)}, checkpoint holds "
            f"{tuple(arr.shape)}")
    if torch.is_tensor(tree):
        if specs is not None:               # copy this rank's block alone
            arr = arr[local_slices(arr.shape, specs, mesh)]
        return _to_torch(arr, tree.dtype)
    want = getattr(tree, "dtype", None)
    return arr if want is None else _as(arr, np.dtype(want))


def _place(tree: Any, like: Any, device: Optional[torch.device]) -> Any:
    """Move the tensor leaves of ``tree`` to ``device`` (None: each
    template leaf's own device, the CUDA device for a meta template)."""
    if isinstance(tree, dict):
        return {k: _place(v, like[k], device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, w, device) for v, w in zip(tree, like))
    if not torch.is_tensor(tree):
        return tree
    dev = device
    if dev is None:
        dev = like.device if like.device.type != "meta" else \
            resolve_device(None)
    return tree.to(dev)


class _Corrupt(Exception):
    """A member of ``arrays.npz`` that did not read back."""


class _Lazy:
    """An open ``np.load`` archive read one array at a time; a damaged
    member raises :class:`_Corrupt`."""

    def __init__(self, z):
        self.z = z

    def __contains__(self, key) -> bool:
        return key in self.z.files

    def __iter__(self):
        return iter(self.z.files)

    def __getitem__(self, key) -> np.ndarray:
        try:
            return self.z[key]
        except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
            raise _Corrupt() from e


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._gc_tmp()

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[Dict] = None,
             blocking: bool = False, shardings: Any = None) -> None:
        """Write ``state`` (nested dicts and lists of tensors, arrays or
        scalars) as checkpoint ``step``.  Every leaf is copied to host
        memory before this returns; the files are written by one
        background thread unless ``blocking``.

        ``shardings=(spec tree, mesh)``: ``state`` holds this rank's
        blocks (a None spec: a whole leaf); every rank must call, each
        leaf is gathered whole, rank 0 writes the files, and every rank
        returns once they are in place."""
        if shardings is not None:
            import torch.distributed as dist
            specs, mesh = shardings
            writer = dist.get_rank() == 0
            host = _gathered_host(state, specs, mesh, writer)
            if writer:
                self._write(step, host, meta, blocking=True)
            dist.barrier()
            return
        host = _flatten(state)          # device -> host copies happen here
        self._write(step, host, meta, blocking)

    def _write(self, step: int, host: Dict[str, np.ndarray],
               meta: Optional[Dict], blocking: bool) -> None:
        self.wait()                     # one in-flight save at a time

        def write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {"step": step, "time": time.time(),
                        "n_arrays": len(host), **(meta or {})}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._prune()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- read -------------------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(int(name[5:]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def read_manifest(self, step: int) -> Dict:
        """The manifest alone: cheap validation before any array is
        read."""
        path = os.path.join(self.dir, f"step_{step:010d}", "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise ValueError(
                f"checkpoint step {step} has no manifest at {path!r}: not "
                f"a checkpoint directory (available steps: "
                f"{self.steps()})") from None
        except json.JSONDecodeError as e:
            raise ValueError(
                f"checkpoint manifest {path!r} is corrupt (truncated or "
                f"overwritten): {e}") from None

    def restore(self, step: int, like: Any, to_device: bool = True,
                device: Optional[torch.device] = None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore checkpoint ``step`` into the structure of ``like``;
        returns ``(tree, manifest)``.

        Only the shapes and dtypes of ``like``'s leaves are read, so meta
        tensors make a template that allocates nothing.  Tensor leaves
        come back as tensors of the template's dtype: on ``device`` when
        given, else on the template leaf's device (the CUDA device for a
        meta leaf), or on the CPU with ``to_device=False``.  Numpy leaves
        come back as host arrays of their dtype either way (an int64 hash
        chain stays exact).

        ``shardings=(spec tree, mesh)`` (a None spec: the whole leaf)
        cuts each tensor leaf to this rank's block as it is read, on any
        mesh: ``like`` describes the full tree.

        Every failure is a readable ``ValueError``: a truncated or
        overwritten ``arrays.npz``, a missing array or a shape that
        differs from the template's (which leaf, expected and found); the
        whole tree is read and checked before anything is returned, so a
        restore never half-applies."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        npz = os.path.join(path, "arrays.npz")
        specs, mesh = shardings if shardings is not None else (None, None)
        try:
            with np.load(npz) as z:
                # on a mesh each array is read when its leaf is cut, so a
                # rank holds one full leaf on the host at a time
                arrays = _Lazy(z) if specs is not None else \
                    {k: z[k] for k in z.files}
                state = _unflatten_into(like, arrays, "", specs, mesh) \
                    if specs is not None else None
        except FileNotFoundError:
            raise ValueError(
                f"checkpoint step {step} not found under {self.dir!r} "
                f"(available steps: {self.steps()})") from None
        except _Corrupt as e:
            raise ValueError(
                f"checkpoint arrays {npz!r} are corrupt (truncated or "
                f"overwritten — atomic rename means this was damaged after "
                f"the save): {e.__cause__}") from None
        except (zipfile.BadZipFile, EOFError, OSError) as e:
            raise ValueError(
                f"checkpoint arrays {npz!r} are corrupt (truncated or "
                f"overwritten — atomic rename means this was damaged after "
                f"the save): {e}") from None
        except ValueError as e:
            if specs is not None:       # a template mismatch, already read
                raise
            raise ValueError(
                f"checkpoint arrays {npz!r} are corrupt (truncated or "
                f"overwritten — atomic rename means this was damaged after "
                f"the save): {e}") from None
        manifest = self.read_manifest(step)
        if state is None:
            state = _unflatten_into(like, arrays)
        if to_device:
            state = _place(state, like, device)
        return state, manifest

    # -- hygiene ----------------------------------------------------------
    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
