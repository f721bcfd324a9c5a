"""The device list the reconstruction service spreads sessions over.

The port of `repro.launch.mesh.session_devices`.  Each session's whole
state lives on one card (`serve3d.placement`), so the service needs a list
of devices, not a partitioned mesh: no tensor is sharded and no collective
runs.
"""
from __future__ import annotations

import torch


def session_devices(n: int | None = None) -> list[torch.device]:
    """The first `n` CUDA cards (all of them when n is None), the substrate
    `serve3d.placement.DevicePlacement` spreads sessions over.  Raises when
    more cards are asked for than the machine has, so a misconfigured fleet
    fails at construction, not mid-serving."""
    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(count)]
    if n is None:
        return devs
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one device, got n={n}")
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} CUDA card(s) are "
                         "available (pass an explicit device list, e.g. "
                         "['cpu'] * n, to place sessions over slots of one device)")
    return devs[:n]
