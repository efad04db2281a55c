"""Procedural 3D shape dataset: seeded, deterministic, drawn on the device.

The JAX package's `data/pointclouds.py` with torch generators in place of
`jax.random` keys.  8 classes with distinct geometry: sphere, cube
(surface), cylinder, cone, torus, plane, helix, cross.  Each sample is
randomly rotated, scaled and jittered, so classification needs real shape
features.  Per-point segmentation labels are the octant of the point in the
shape's CANONICAL frame (the net must undo the rotation from geometry
alone).

The geometry is a pure function of its draws (`batch_from_draws`): the
uniform cube coordinates u, the curve parameter t, the normal draws of the
sphere, the Gaussian 3x3 behind the rotation, the scale and the jitter.
`sample_batch` draws them with a `torch.Generator` on the batch's device;
a test can feed `batch_from_draws` the JAX package's own draws instead.
The two generators give different numbers from one seed, so the packages'
streams are alike in distribution, not in values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.device import resolve_device

N_CLASSES = 8
N_SEG_CLASSES = 8  # canonical octants


def _unit(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def make_shapes(u: torch.Tensor, t: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Canonical-frame points of all 8 classes from one set of draws.

    u (..., n, 3) uniform in [-1, 1), t (..., n) uniform in [0, 1), normal
    (..., n, 3) standard normal -> (..., 8, n, 3), class c at index c, as
    the reference's `_make_shape` stacks them.
    """
    u0, u1, u2 = u.unbind(-1)
    sphere = _unit(normal)
    # cube surface: project onto the largest |coord| face
    face = u.abs().argmax(dim=-1, keepdim=True)
    cube = u.scatter(-1, face, torch.sign(u.gather(-1, face)))
    theta = 2 * math.pi * t
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    cylinder = torch.stack([cos_t, sin_t, u2], dim=-1)
    r_cone = 1.0 - t
    cone = torch.stack([r_cone * cos_t, r_cone * sin_t, 2 * t - 1], dim=-1)
    phi = 2 * math.pi * u0
    ring = 0.7 + 0.3 * torch.cos(phi)
    torus = torch.stack([ring * cos_t, ring * sin_t, 0.3 * torch.sin(phi)], dim=-1)
    plane = torch.stack([u0, u1, 0.05 * u2], dim=-1)
    hz = 2 * t - 1
    helix = torch.stack([torch.cos(3 * math.pi * hz), torch.sin(3 * math.pi * hz), hz], dim=-1)
    helix = helix + 0.05 * u  # thickness
    # cross: two orthogonal bars
    bar = torch.stack([u0, 0.15 * u1, 0.15 * u2], dim=-1)
    swap = (u2 > 0)[..., None]
    cross = torch.where(swap, bar[..., [1, 0, 2]], bar)
    return torch.stack([sphere, cube, cylinder, cone, torus, plane, helix, cross], dim=-3)


def rotation_from_gaussian(a: torch.Tensor) -> torch.Tensor:
    """Uniform random rotation from a Gaussian (..., 3, 3): QR, R's diagonal made
    positive, det fixed to +1 by flipping the first column."""
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    det = torch.linalg.det(q)
    return torch.cat([q[..., :1] * torch.sign(det)[..., None, None], q[..., 1:]], dim=-1)


def seg_labels(canon: torch.Tensor) -> torch.Tensor:
    """Octant of each canonical point: (..., n, 3) -> (..., n) int64 in [0, 8)."""
    pos = (canon > 0).to(torch.int64)
    return pos[..., 0] * 4 + pos[..., 1] * 2 + pos[..., 2]


def batch_from_draws(cls_id, u, t, normal, a, scale, jitter) -> tuple:
    """One batch from its draws: the reference's per-sample body, batched.

    cls_id (B,) ints in [0, 8); u, normal, jitter (B, n, 3); t (B, n);
    a (B, 3, 3); scale (B,) in [0.7, 1.3).  `jitter` is the standard normal
    draw, scaled by 0.02 here.  Returns (points (B, n, 3) float32,
    cls_labels (B,) int64, seg_labels (B, n) int64).
    """
    cls_id = torch.as_tensor(cls_id).to(torch.int64)
    shapes = make_shapes(u, t, normal)  # (B, 8, n, 3)
    pick = cls_id.to(shapes.device)[:, None, None, None].expand(-1, 1, *shapes.shape[-2:])
    canon = shapes.gather(1, pick)[:, 0]
    rot = rotation_from_gaussian(a)
    pts = torch.matmul(canon * scale[:, None, None], rot.transpose(-1, -2))
    pts = pts + 0.02 * jitter
    return pts.to(torch.float32), cls_id.to(pts.device), seg_labels(canon)


def fold_in(seed: int, *data: int) -> int:
    """A 64-bit generator seed derived from `seed` and `data` alone, as
    `jax.random.fold_in` derives a key: equal inputs, equal seed."""
    return int(np.random.SeedSequence([seed, *data]).generate_state(1, np.uint64)[0])


def sample_batch(seed, batch: int, n_points: int = 1024, *, device=None) -> tuple:
    """Returns (points (B, N, 3) float32, cls_labels (B,) int64, seg_labels (B, N) int64).

    `seed` is an int (a generator on `device` is seeded with it) or a
    `torch.Generator` on `device`.  Everything is drawn on `device`, the
    card by default; pass "cpu" for the CPU.
    """
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    shape = (batch, n_points)
    kw = dict(generator=gen, device=dev)
    cls_id = torch.randint(0, N_CLASSES, (batch,), **kw)
    u = torch.rand(*shape, 3, **kw) * 2 - 1
    t = torch.rand(*shape, **kw)
    normal = torch.randn(*shape, 3, **kw)
    a = torch.randn(batch, 3, 3, **kw)
    scale = torch.rand(batch, **kw) * 0.6 + 0.7
    jitter = torch.randn(*shape, 3, **kw)
    return batch_from_draws(cls_id, u, t, normal, a, scale, jitter)


def data_stream(seed: int, batch: int, n_points: int = 1024, *, shard_id: int = 0,
                n_shards: int = 1, device=None):
    """Infinite deterministic host-shardable stream of `sample_batch` batches.

    Step s of shard k draws from `fold_in(seed, s, k * 7919)` alone, so
    resuming at step S reproduces the exact batch (restart-exact).
    """
    step = 0
    while True:
        yield sample_batch(fold_in(seed, step, shard_id * 7919), batch, n_points, device=device)
        step += n_shards
