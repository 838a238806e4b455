"""Device discovery and mesh construction (port of
``legalrag_tpu/parallel/mesh.py``).

The engine scales over a 2-D ``(data, model)`` mesh: query batches split
over ``data``, corpus rows over ``model`` (each device owns a slice of the
doc axis; the per-shard top-k lists are merged on a lead device). JAX's
sharded search is one process over a mesh of local devices; so is this
one. A ``Mesh`` is a ``[data, model]`` grid of ``torch.device``s. A grid may
name one device more than once: then every shard's work runs on that one
card, at shard shapes, with the global row offsets and the merge, and only
the copies between cells cost nothing.

The placement helpers (``replicated``, ``row_sharded``, ``batch_sharded``)
return a grid of per-cell tensors, ``cells[i][j]`` on
``mesh.devices[i][j]``, where JAX returns a ``NamedSharding``.

Multi-host serving (``init_multihost``) is not ported: it needs one process
per host and ``torch.distributed``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

Cells = List[List[torch.Tensor]]


class Mesh:
    """A ``[data, model]`` grid of devices with JAX's ``Mesh`` fields:
    ``devices`` (a numpy object array), ``axis_names`` and ``shape``
    (axis name -> size)."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, MODEL_AXIS)):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def lead(self) -> torch.device:
        """The device the shards' lists are merged on."""
        return self.devices[0, 0]

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def local_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The visible CUDA devices, or ``[cpu]`` for ``platform="cpu"``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform not in (None, "cuda"):
        raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devs: Sequence, rows: int, cols: int) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr.reshape(rows, cols)


def make_mesh(devices: Optional[Sequence[torch.device]] = None,
              data: Optional[int] = None, model: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` mesh; by default every device on ``model`` (the
    corpus axis), as in JAX."""
    devs = list(devices) if devices is not None else local_devices()
    n = len(devs)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model  # type: ignore[operator]
    elif model is None:
        model = n // data
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    return Mesh(_grid(devs, data, model))


def init_multihost() -> bool:
    """JAX's ``init_multihost`` is a no-op (False) without
    ``JAX_COORDINATOR_ADDRESS``; so is this. With it set, JAX joins a
    multi-host cluster; the port has no multi-host serving yet and refuses,
    rather than serve the process-local devices under a multi-host
    config."""
    if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return False
    raise RuntimeError(
        "JAX_COORDINATOR_ADDRESS is set, but multi-host serving is not "
        "ported to legalrag_tpu_torch (the torch.distributed slice, ROADMAP "
        "A6b); unset it to serve from this host's devices")


def _device_key(d):
    """(slice, process, id) of a device-like object: JAX's device fields,
    or a ``torch.device``'s index (one slice, one process)."""
    ident = getattr(d, "id", None)
    if ident is None:
        ident = getattr(d, "index", None) or 0
    return (getattr(d, "slice_index", 0) or 0,
            getattr(d, "process_index", 0) or 0, ident)


def slice_major_order(devices: Sequence) -> tuple:
    """Order devices (slice, process, id)-major and return ``(n_slices,
    ordered)``: the corpus (``model``) axis lies within a slice, the
    ``data`` axis across slices. Pure function (testable with stub
    devices)."""
    order = sorted(devices, key=_device_key)
    n_slices = len({_device_key(d)[0] for d in order})
    return n_slices, order


def make_global_mesh(devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """``(data, model)`` mesh over every visible device: ``data`` = slices,
    ``model`` = devices within a slice; one slice gives ``(1, n)``."""
    devs = list(devices) if devices is not None else local_devices()
    n_slices, order = slice_major_order(devs)
    assert len(order) % n_slices == 0, \
        f"{len(order)} devices do not tile {n_slices} slices"
    return Mesh(_grid(order, n_slices, len(order) // n_slices))


def place(mesh: Mesh, x: torch.Tensor, data_dim: Optional[int] = None,
          model_dim: Optional[int] = None) -> Cells:
    """Per-cell copies of ``x``: split along ``data_dim`` over the data
    axis and along ``model_dim`` over the model axis (each must divide
    evenly), replicated over an axis given no dim."""
    def split(t, dim, parts, i):
        if dim is None:
            return t
        n = t.shape[dim]
        if n % parts:
            raise ValueError(f"dim {dim} of size {n} does not split into "
                             f"{parts} shards")
        step = n // parts
        return t.narrow(dim, i * step, step)

    nd, nm = mesh.devices.shape
    return [[split(split(x, data_dim, nd, i), model_dim, nm, j)
             .contiguous().to(mesh.devices[i, j]) for j in range(nm)]
            for i in range(nd)]


def as_cells(mesh: Mesh, x, data_dim: Optional[int] = None,
             model_dim: Optional[int] = None) -> Cells:
    """``x`` as a grid of per-cell tensors: a tensor is placed, a list of
    model shards is copied to every data row, a grid is taken as it is."""
    if isinstance(x, torch.Tensor):
        return place(mesh, x, data_dim, model_dim)
    if isinstance(x[0], torch.Tensor):
        return [[t.to(mesh.devices[i, j]) for j, t in enumerate(x)]
                for i in range(mesh.devices.shape[0])]
    return x


def replicated(mesh: Mesh, x: torch.Tensor) -> Cells:
    return place(mesh, x)


def row_sharded(mesh: Mesh, x: torch.Tensor) -> Cells:
    """Dim 0 (corpus rows) split over the model axis."""
    return place(mesh, x, model_dim=0)


def batch_sharded(mesh: Mesh, x: torch.Tensor) -> Cells:
    """Dim 0 (query batch) split over the data axis."""
    return place(mesh, x, data_dim=0)
