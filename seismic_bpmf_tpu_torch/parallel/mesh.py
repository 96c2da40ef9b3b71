"""Device meshes for a single controller.

Counterpart of `seismic_bpmf_tpu/parallel/mesh.py`.  The JAX package maps
its axes of parallelism onto a `jax.sharding.Mesh` and runs one program
over it; here one Python process drives every device of the mesh, so a
`Mesh` is an array of `torch.device`s with axis names:

  - 'src'  : beamforming source-grid axis (the max/argmax over sources
             becomes a max over the shards, then the smallest source index
             among those that reach it)
  - 'tp'   : matched-filter template axis
  - 'time' : the continuous-data time axis, in contiguous chunks with a
             halo of max(moveout) (+ template_len) copied from the
             neighbouring chunk's device

A device may appear more than once.  `[torch.device("cuda:0")] * 8` is a
virtual 8-device mesh on one card: every shard's kernel runs there at its
own offset and the halos move by device copies, which checks the sharded
path; it is no faster than the unsharded scan.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device


class Mesh:
    """An n-dimensional array of `torch.device`s with one name per axis
    (the `jax.sharding.Mesh` interface the sharded functions read:
    `devices`, `axis_names`, `shape`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axis names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, *axes: str) -> np.ndarray:
        """The devices along `axes`, in that order, at index 0 of every
        other axis (their replicas); an axis the mesh lacks has size 1."""
        devs = self.devices
        names = list(self.axis_names)
        for name in names[::-1]:
            if name not in axes:
                devs = np.take(devs, 0, axis=names.index(name))
                names.remove(name)
        for name in axes:
            if name not in names:
                devs = devs[..., None]
                names.append(name)
        return np.transpose(devs, [names.index(a) for a in axes])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh.

    axis_sizes : mapping axis name -> size, e.g. {'src': 4, 'time': 2}.
        If None, a 1-D mesh over all devices with axis 'work'.
        One entry may be -1 to absorb the remaining devices.
    devices : the devices (anything `torch.device` takes); None means every
        visible CUDA device, and raises without CUDA.  A device may repeat:
        ``[torch.device("cpu")] * 8`` is a virtual 8-device mesh.
    """
    if devices is None:
        resolve_device(None)                  # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    # 'cuda' means the current card: name it, as tensors report it
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"work": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} does not match {n} devices"
        )
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(sizes), tuple(names))


def mesh_device(mesh, device=None) -> torch.device:
    """The device of an engine built with `mesh=`: without a mesh, `device`
    as the package rule resolves it; with one, the mesh's first device,
    where the sharded results gather (`device`, if given, must be it).  A
    mesh of another kind raises NotImplementedError: only this
    single-controller `Mesh` is ported."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"mesh= takes a seismic_bpmf_tpu_torch.parallel.Mesh "
            f"(make_mesh), not {type(mesh).__name__}: a process-group mesh, "
            f"one rank per card, is not ported (ROADMAP Queue 1 #19, now "
            f"#29)")
    first = mesh.devices.flat[0]
    if device is not None and resolve_device(device) != first:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}, where the sharded results gather")
    return first
