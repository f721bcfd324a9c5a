"""Procedural 3D scenes with analytic ground truth (NeRF-Synthetic stand-in).

The port of `repro.data.synthetic_scene`.  `make_scene` draws with
`np.random.default_rng(seed)` in the reference's order, so a seed rebuilds
the reference's scene bit for bit.  Ground-truth images are rendered
through the same volume-rendering equation the NeRF uses (dense sampling of
the analytic field), so PSNR against them is meaningful.  Rendering runs on
an explicit device; images, depths and poses come back as numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rendering
from ..kernels.volume_render import ref as vr_ref


class SceneParams(NamedTuple):
    centers: torch.Tensor   # (K, 3)
    radii: torch.Tensor     # (K,)
    kinds: torch.Tensor     # (K,) 0=sphere 1=box 2=torus
    albedo: torch.Tensor    # (K, 3)
    density: torch.Tensor   # (K,) peak density
    sharp: torch.Tensor     # (K,) edge sharpness


def make_scene(seed: int, n_primitives: int = 5, device="cuda") -> SceneParams:
    rng = np.random.default_rng(seed)
    k = n_primitives
    centers = rng.uniform(-0.8, 0.8, size=(k, 3)).astype(np.float32)
    radii = rng.uniform(0.18, 0.45, size=k).astype(np.float32)
    kinds = rng.integers(0, 3, size=k).astype(np.int32)
    albedo = rng.uniform(0.15, 0.95, size=(k, 3)).astype(np.float32)
    density = rng.uniform(20.0, 40.0, size=k).astype(np.float32)
    sharp = rng.uniform(25.0, 50.0, size=k).astype(np.float32)
    return SceneParams(*(torch.from_numpy(a).to(device)
                         for a in (centers, radii, kinds, albedo, density, sharp)))


def _sdf(scene: SceneParams, points: torch.Tensor) -> torch.Tensor:
    """Signed distance to each primitive: points (N, 3) -> (N, K)."""
    d = points[:, None, :] - scene.centers[None, :, :]
    r = scene.radii[None, :]
    sphere = torch.linalg.norm(d, dim=-1) - r
    box = torch.amax(torch.abs(d), dim=-1) - r * 0.8
    ring = torch.sqrt(torch.square(torch.linalg.norm(d[..., :2], dim=-1) - r)
                      + torch.square(d[..., 2]))
    torus = ring - r * 0.35
    k = scene.kinds[None, :]
    return torch.where(k == 0, sphere, torch.where(k == 1, box, torus))


def scene_density(scene: SceneParams, points: torch.Tensor) -> torch.Tensor:
    """Analytic density field: (N, 3) world coords -> (N,)."""
    occ = torch.sigmoid(-_sdf(scene, points) * scene.sharp[None, :])
    return torch.amax(scene.density[None, :] * occ, dim=-1)


def scene_color(scene: SceneParams, points: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Analytic radiance: dominant primitive's albedo + soft lambert shading."""
    w = torch.softmax(-_sdf(scene, points) * 20.0, dim=-1)
    base = w @ scene.albedo
    n = points - w @ scene.centers
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-6)
    lam = 0.65 + 0.35 * torch.clamp(torch.sum(-dirs * n, dim=-1, keepdim=True), 0.0, 1.0)
    return torch.clamp(base * lam, 0.0, 1.0)


def _render_gt_rays(scene, origins, dirs, cfg: rendering.RenderConfig, n_samples: int):
    b = origins.shape[0]
    ts = rendering._linspace(cfg.near, cfg.far, n_samples, origins.device)[None, :].repeat(b, 1)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    flat = pts.reshape(-1, 3)
    fdirs = torch.broadcast_to(dirs[:, None, :], pts.shape).reshape(-1, 3)
    sigma, rgb = scene_density(scene, flat), scene_color(scene, flat, fdirs)
    live = rendering.inside_aabb(flat, cfg)
    sigma = torch.where(live, sigma, torch.zeros_like(sigma)).reshape(b, n_samples)
    rgb = rgb.reshape(b, n_samples, 3)
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + (cfg.far - cfg.near) / n_samples)
    out = vr_ref.composite(sigma, rgb, deltas, ts)
    color = out.color + (1.0 - out.opacity[..., None]) if cfg.white_background else out.color
    return color, out.depth


@torch.no_grad()
def render_gt(scene: SceneParams, pose: np.ndarray, h: int, w: int, focal: float,
              cfg: rendering.RenderConfig, n_samples: int = 192, chunk: int = 8192):
    """Ground-truth RGB (H, W, 3) and depth (H, W), numpy, by dense analytic
    ray marching on the scene's device."""
    device = scene.centers.device
    py, px = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=device)
    rgb_out, depth_out = [], []
    for i in range(0, px.shape[0], chunk):
        o, d = rendering.pixel_rays(pose_t, px[i:i + chunk], py[i:i + chunk], h, w, focal)
        rgb, depth = _render_gt_rays(scene, o, d, cfg, n_samples)
        rgb_out.append(rgb)
        depth_out.append(depth)
    rgb = torch.cat(rgb_out).reshape(h, w, 3)
    depth = torch.cat(depth_out).reshape(h, w)
    return rgb.cpu().numpy(), depth.cpu().numpy()


class SceneDataset(NamedTuple):
    """Posed training images + intrinsics for one scene."""
    images: np.ndarray   # (V, H, W, 3)
    depths: np.ndarray   # (V, H, W)
    poses: np.ndarray    # (V, 3, 4)
    focal: float
    h: int
    w: int


def build_dataset(seed: int, n_views: int = 24, h: int = 64, w: int = 64,
                  fov_deg: float = 50.0, cfg: rendering.RenderConfig | None = None,
                  gt_samples: int = 192, device="cuda") -> tuple[SceneParams, SceneDataset]:
    cfg = cfg or rendering.RenderConfig()
    scene = make_scene(seed, device=device)
    poses = rendering.sphere_poses(n_views, seed=seed)
    focal = 0.5 * w / np.tan(np.deg2rad(fov_deg) / 2)
    imgs, deps = [], []
    for v in range(n_views):
        rgb, dep = render_gt(scene, poses[v], h, w, focal, cfg, n_samples=gt_samples)
        imgs.append(rgb)
        deps.append(dep)
    return scene, SceneDataset(np.stack(imgs), np.stack(deps), poses, float(focal), h, w)
