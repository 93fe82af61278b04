"""The devices that site shards live on.

Port of wgbs_tools_tpu/parallel/mesh.py::make_mesh for the one axis the
port shards, the CpG sites: a plain list of torch devices, shard i on
devices[i].
"""

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
