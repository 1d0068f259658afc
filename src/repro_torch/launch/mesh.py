"""Meshes of ``torch.distributed`` ranks (twin of ``repro.launch.mesh``)
and the one helper that spawns them.

The reference's mesh is a grid of devices inside one process; the port's
is a grid of processes, one rank each, joined by ``torch.distributed``.
:class:`Mesh` wraps a ``DeviceMesh`` from
``torch.distributed.device_mesh.init_device_mesh`` and keeps the
reference's view of it: ``shape`` maps each axis name to its size (as a
jax ``Mesh.shape`` does), :meth:`Mesh.coordinate` is this rank's index
along an axis and :meth:`Mesh.group` the process group of the ranks that
differ from it only along that axis.  The backend is explicit: ``gloo``
(CPU ranks, or ranks that share one card) or ``nccl`` (one card a rank).
Ranks compute on the card unless the caller passes ``device="cpu"``; with
no card that default raises, as every entry point of the port does.

Functions, never module-level meshes: importing this module touches no
process group.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing``'s
``spawn`` context on ``MASTER_ADDR=127.0.0.1`` and a free port, runs
``fn(rank, world, *args)`` in each after joining the process group, and
returns each rank's result, read from one result queue.  The tests,
``chip_smoke.py`` and ``launch/serve.py --mesh`` all start their ranks
through it.
"""
from __future__ import annotations

import os
import pickle
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("gloo", "nccl")


class Mesh:
    """A grid of ranks with named axes over one ``DeviceMesh``.

    ``device`` is the device this rank computes on; ``backend`` the
    process group's.  Axes of size 1 take part in no collective."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        sizes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.device = torch.device(device)
        self.backend = backend
        # pinned host buffers, one a dtype, that a gloo collective of a CUDA
        # tensor stages through (``distributed/sharding.py``), grown to the
        # largest call: a fresh pinned allocation per call costs more than
        # the copy
        self.staging: Dict[torch.dtype, torch.Tensor] = {}
        rank = dist.get_rank()
        self._coord = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank,
                                                                 sizes))))

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coord[axis]

    def group(self, axis: str):
        """The process group of the ranks that share every coordinate of
        this rank but ``axis``'s."""
        return self.device_mesh.get_group(mesh_dim=axis)

    def __repr__(self) -> str:
        dims = "x".join(str(n) for n in self.shape.values())
        return (f"Mesh({dims} {self.axis_names}, {self.backend}, "
                f"{self.device})")


def _check_backend(backend: str, device, world: int) -> torch.device:
    """The backend's name, what NCCL needs, then the device (the card
    unless ``device`` says otherwise: no card raises).  Returns the
    resolved device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if torch.device(device or "cuda").type != "cuda":
            raise ValueError("the nccl backend needs CUDA ranks")
        if torch.cuda.device_count() < world:
            raise ValueError(
                f"the nccl backend needs a card for each rank: {world} "
                f"ranks, {torch.cuda.device_count()} cards (NCCL refuses "
                "two ranks on one device; use --backend gloo)")
    return resolve_device(device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None, backend: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over every rank of the initialized process
    group (whose size must be the product of ``shape``), axes named
    ``axes``.  ``device`` (where this rank computes) defaults to
    ``cuda:<current>``; the CPU only when asked for."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch the ranks through spawn)")
    backend = backend or dist.get_backend()
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"ranks, the process group has {world}")
    _check_backend(backend, device, world)
    # the DeviceMesh's own device type only picks its groups' backend: a
    # gloo mesh's ranks may still compute on a card they share
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(dm, device, backend)


def make_test_mesh(data: int = 1, model: int = 1, device=None
                   ) -> Optional[Mesh]:
    """A ``(data, model)`` mesh over the process group, or None when the
    group has fewer than ``data * model`` ranks (or none is initialized).
    The port's test meshes cover the whole group: a smaller request than
    the group raises."""
    if not dist.is_initialized() or data * model > dist.get_world_size():
        return None
    return make_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: 16 x 16 = 256 ranks on ``("data", "model")``.  Multi-pod:
    2 x 16 x 16 = 512 on ``("pod", "data", "model")``.  Builds only at that
    world size; raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the process group has {world}")
    return make_mesh(shape, axes, device)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listened on a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, device: str,
               fn: Callable, args: Sequence[Any], queue) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:        # a card a rank, round robin
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: a tensor crosses as bytes, not as a shared-memory
        # handle that dies with this process
        queue.put((rank, True, pickle.dumps(out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          backend: str = "gloo", device: Optional[str] = None,
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes joined in
    one ``backend`` process group (``device``: where each rank computes:
    ``"cuda"`` (the default) for card ``rank % cards`` (all on one card when
    there is one), one named card they share, or ``"cpu"`` when asked
    for).  ``fn`` and
    ``args`` must pickle (``fn`` a module-level function).  Returns the
    results by rank; raises ``RuntimeError`` with the first failing rank's
    traceback.  Every process is joined, or killed at ``timeout``."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    device = str(_check_backend(backend, device, world))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, fn, tuple(args),
                               q), daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: List[str] = []
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, out = q.get(timeout=timeout)
            except queue_mod.Empty:
                errors.append(f"no result within {timeout:.0f} s")
                break
            if ok:
                results[rank] = pickle.loads(out)
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a spawned rank failed: " + errors[0])
    return [results[r] for r in range(world)]
