"""Batched on-device augmentation.

Port of `wireframe_tpu/data/augment.py`: X-flip (p=0.5), Y-flip (p=0.5),
a z-rotation uniform in +-rot_degrees, optional Gaussian XYZ jitter on
the valid point rows only and an optional per-sample uniform scale,
applied consistently to the point clouds AND the target vertices.

`augment_batch` draws from a `torch.Generator`; `augment_batch_from_draws`
does the arithmetic, so tests can hand it the JAX package's draws.

Under data parallelism (`rows`), each rank draws the flips, angles,
noise and scales of the WHOLE batch from its generator, seeded as every
other rank's, and applies its own rows' draws: the augmentation is the
one-device run's.  The model's dropout masks, drawn per layer on each
rank's own shapes after this, are not: a check that ranks reproduce the
one-device step turns dropout off.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def augment_batch_from_draws(point_clouds: torch.Tensor,
                             target_vertices: torch.Tensor,
                             flip_x: torch.Tensor, flip_y: torch.Tensor,
                             angle: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             scale: Optional[torch.Tensor] = None,
                             jitter_std: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    point_clouds (B, N, D), first 3 channels XYZ; target_vertices (B, V, 3)
    zero-padded; flip_x, flip_y (B,) bool; angle (B,) radians; noise
    (B, N, 3) standard normal (used when jitter_std > 0); scale (B, 1, 1)
    or None.  Returns the augmented (point_clouds, target_vertices).
    """
    dt = point_clouds.dtype
    sx = torch.where(flip_x, -1.0, 1.0).to(dt)
    sy = torch.where(flip_y, -1.0, 1.0).to(dt)
    c, s = torch.cos(angle.to(dt)), torch.sin(angle.to(dt))
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    # Per-sample 3x3 map: rotz(angle) @ diag(sx, sy, 1).
    rot = torch.stack([
        torch.stack([c * sx, -s * sy, zeros], dim=-1),
        torch.stack([s * sx, c * sy, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)                                              # (B, 3, 3)
    if scale is not None:
        rot = rot * scale
    xyz = torch.einsum("bnc,bdc->bnd", point_clouds[..., :3], rot)
    if jitter_std > 0.0:
        # An all-zero RAW row is padding; jitter only the others.
        valid = torch.any(point_clouds != 0.0, dim=-1, keepdim=True)
        xyz = xyz + torch.where(valid, jitter_std * noise,
                                torch.zeros_like(noise))
    point_clouds = torch.cat([xyz, point_clouds[..., 3:]], dim=-1)
    target_vertices = torch.einsum("bvc,bdc->bvd", target_vertices, rot)
    return point_clouds, target_vertices


def augment_batch(generator: Optional[torch.Generator],
                  point_clouds: torch.Tensor, target_vertices: torch.Tensor,
                  rot_degrees: float = 5.0, jitter_std: float = 0.0,
                  scale_range: float = 0.0,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the flips, angles, noise and scales from `generator` (on the
    batch's device) and apply them; see `augment_batch_from_draws`.
    rows: (first row, whole batch) when `point_clouds` are rows
    first .. first + b of a larger batch: the whole batch's draws are
    made and these rows' applied."""
    b = point_clouds.shape[0]
    first, total = (0, b) if rows is None else rows
    dev = point_clouds.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    mine = slice(first, first + b)
    flip_x = (torch.rand(total, generator=generator, device=dev) < 0.5)[mine]
    flip_y = (torch.rand(total, generator=generator, device=dev) < 0.5)[mine]
    rot_rad = rot_degrees * math.pi / 180.0
    angle = uniform((total,), -rot_rad, rot_rad)[mine]
    noise = None
    if jitter_std > 0.0:
        noise = torch.randn((total,) + point_clouds.shape[1:-1] + (3,),
                            generator=generator, device=dev)[mine]
    scale = (uniform((total, 1, 1), 1.0 - scale_range,
                     1.0 + scale_range)[mine]
             if scale_range > 0.0 else None)
    return augment_batch_from_draws(point_clouds, target_vertices, flip_x,
                                    flip_y, angle, noise, scale, jitter_std)
