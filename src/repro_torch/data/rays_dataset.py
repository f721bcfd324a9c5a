"""Pixel/ray batch sampling (paper steps 1-2): random pixels across views.

The port of `repro.data.rays_dataset`.  All rays are precomputed once (V*H*W
rows) on the sampler's device; a batch is a gather of uniform random row
indices, drawn from a `torch.Generator` (`sample_idx`) or handed in ready-
made (`gather`) -- the trainer's draw stream, which tests fill with the
reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rendering
from .synthetic_scene import SceneDataset


class RaySampler:
    def __init__(self, ds: SceneDataset, views=None, device="cuda"):
        """views: optional iterable of view indices to draw from (default:
        all), so callers can hold out eval views."""
        all_v, h, w = ds.images.shape[:3]
        views = list(range(all_v)) if views is None else sorted(views)
        py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        px, py = px.reshape(-1), py.reshape(-1)
        origins, dirs = [], []
        for vi in views:
            o, d = rendering.pixel_rays(torch.as_tensor(ds.poses[vi], dtype=torch.float32),
                                        px, py, h, w, ds.focal)
            origins.append(o)
            dirs.append(d)
        self.views = views
        self.device = torch.device(device)
        self.origins = torch.cat(origins).contiguous().to(device)
        self.dirs = torch.cat(dirs).contiguous().to(device)
        self.rgb = torch.from_numpy(
            np.ascontiguousarray(ds.images[views].reshape(-1, 3), dtype=np.float32)).to(device)
        self.n = self.rgb.shape[0]

    def sample_idx(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """A batch of uniform ray indices in [0, n), on the generator's device."""
        return torch.randint(0, self.n, (batch,), generator=generator,
                             device=generator.device)

    def gather(self, idx: torch.Tensor) -> rendering.RayBatch:
        idx = idx.to(device=self.device, dtype=torch.int64)
        return rendering.RayBatch(self.origins[idx], self.dirs[idx], self.rgb[idx])
