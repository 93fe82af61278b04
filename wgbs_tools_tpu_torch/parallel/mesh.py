"""The devices that site shards and sample shards live on.

Port of wgbs_tools_tpu/parallel/mesh.py. `shard_devices` lists one torch
device per site shard (the one axis pat2beta shards); `make_mesh` arranges
devices as the JAX package's (samples, sites) mesh, for the analysis step
and the window-sharded segmentation. There are no collectives to name the
axes for: the port moves tensors between the mesh's devices itself
(parallel/sharded.py). Devices repeat round-robin in both, so several
shards may share one card (or the CPU), which is how a multi-card mesh
stands in on one card and in the tests.
"""

import numpy as np
import torch

from ..device import resolve_device


def shard_devices(device="cuda", n_shards=None):
    """A list of torch devices, one per site shard.

    `device` "cuda" means every visible CUDA device, "cuda:N" that one
    device, "cpu" the host (raises, as resolve_device does, when CUDA is
    asked for and absent). With `n_shards` the devices repeat round-robin,
    so several shards may share one card (or the CPU); the default is one
    shard per device."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        base = [torch.device("cpu")]
    elif dev.index is None:
        base = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    n = len(base) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return [base[i % len(base)] for i in range(n)]


class Mesh:
    """A (samples, sites) grid of torch devices: `devices` is the flat list,
    samples-major (JAX's mesh.devices.reshape(-1)), `shape` {"samples": a,
    "sites": b} and `device(s, j)` the device of sample shard s and site
    shard j. Site shard j's own device, where its counts, its summed cost
    and its DP live, is device(0, j)."""

    axis_names = ("samples", "sites")

    def __init__(self, devices, samples_axis):
        self.devices = list(devices)
        n = len(self.devices)
        if samples_axis < 1 or n % samples_axis:
            raise ValueError(f"{n} devices cannot host {samples_axis} sample "
                             "shards")
        self.shape = {"samples": samples_axis, "sites": n // samples_axis}

    @property
    def size(self):
        return len(self.devices)

    def device(self, s, j):
        return self.devices[s * self.shape["sites"] + j]


def make_mesh(n_devices=None, samples_axis=1, devices=None, device="cuda"):
    """Create a (samples, sites) mesh. Without `devices` its devices are
    shard_devices(device, n_devices): every visible card (or the CPU) once,
    or n_devices of them round-robin; with `devices`, their first n_devices
    (JAX's rule)."""
    if devices is None:
        devices = shard_devices(device, n_shards=n_devices)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices, samples_axis)


def pad_to_multiple(x, multiple, axis=0, fill=0):
    """Pad an array along `axis` so its length divides evenly for sharding."""
    n = x.shape[axis]
    target = (n + multiple - 1) // multiple * multiple
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)
