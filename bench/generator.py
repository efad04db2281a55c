"""The benchmark's one traffic generator: clouds, batch pools and open-loop arrivals.

A traffic mix is a JSON file of parameters (`bench/traffic/<mix>.json`);
everything here reads only those parameters and `--seed`.  Clouds are made
on the host with NumPy.  The shapes are a frozen copy of the procedural
dataset of the program's `data/pointclouds.py` (sphere, cube surface,
cylinder, cone, torus, plane, helix, cross; a random rotation, scale and
jitter), so the spatial layout that MSP, FPS and the lattice query see
cannot move with the program.

* "objects": one shape a cloud, the classification input.
* "scenes": a block of `shapes` objects (scaled down, standing on a ground
  plane), the segmentation input: an S3DIS-style block of one room.

Every cloud has its own generator, seeded from (seed, stream, index), so a
pool is the same whatever order it is made in.
"""

from __future__ import annotations

import math

import numpy as np

N_SHAPES = 8
# the seed's independent streams: clouds, sizes, request order, arrivals, the check's sample
STREAM_POOL, STREAM_SIZES, STREAM_ORDER, STREAM_ARRIVALS, STREAM_CHECK = 1, 2, 3, 4, 5


def rng_for(seed: int, *path: int) -> np.random.Generator:
    """A generator from the seed and a path of small ints alone."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), *path])))


def _unit(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-9)


def shape_points(cls_id: int, rng: np.random.Generator, n: int) -> np.ndarray:
    """n canonical-frame points of shape `cls_id` (0..7), float64 (n, 3)."""
    u = rng.uniform(-1.0, 1.0, (n, 3))
    t = rng.uniform(0.0, 1.0, n)
    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
    theta = 2 * math.pi * t
    c, s = np.cos(theta), np.sin(theta)
    if cls_id == 0:  # sphere
        return _unit(rng.normal(size=(n, 3)))
    if cls_id == 1:  # cube surface: each point pushed to its largest face
        face = np.abs(u).argmax(axis=-1)
        out = u.copy()
        out[np.arange(n), face] = np.sign(u[np.arange(n), face])
        return out
    if cls_id == 2:  # cylinder
        return np.stack([c, s, u2], axis=-1)
    if cls_id == 3:  # cone
        r = 1.0 - t
        return np.stack([r * c, r * s, 2 * t - 1], axis=-1)
    if cls_id == 4:  # torus
        phi = 2 * math.pi * u0
        ring = 0.7 + 0.3 * np.cos(phi)
        return np.stack([ring * c, ring * s, 0.3 * np.sin(phi)], axis=-1)
    if cls_id == 5:  # plane
        return np.stack([u0, u1, 0.05 * u2], axis=-1)
    if cls_id == 6:  # helix with thickness
        hz = 2 * t - 1
        helix = np.stack([np.cos(3 * math.pi * hz), np.sin(3 * math.pi * hz), hz], axis=-1)
        return helix + 0.05 * u
    bar = np.stack([u0, 0.15 * u1, 0.15 * u2], axis=-1)  # cross: two orthogonal bars
    return np.where((u2 > 0)[:, None], bar[:, [1, 0, 2]], bar)


def rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform random rotation: QR of a Gaussian, R's diagonal made positive, det +1."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))[None, :]
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def object_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """One shape, rotated, scaled in [0.7, 1.3) and jittered by 0.02: (n, 3) float32."""
    cls_id = int(rng.integers(0, N_SHAPES))
    pts = shape_points(cls_id, rng, n) @ rotation(rng).T * rng.uniform(0.7, 1.3)
    return (pts + 0.02 * rng.normal(size=(n, 3))).astype(np.float32)


def scene_cloud(rng: np.random.Generator, n: int, shapes: tuple, ground: float) -> np.ndarray:
    """A block: a ground plane over [-1, 1]^2 and shapes[0]..shapes[1] objects on it.

    Each object is scaled to 0.15-0.3 of the block, turned about the vertical
    axis and set on the ground at a random place.  `ground` is the share of
    the n points on the plane; the rest are spread over the objects.
    """
    k = int(rng.integers(shapes[0], shapes[1] + 1))
    n_ground = int(round(ground * n))
    counts = rng.multinomial(n - n_ground, np.full(k, 1.0 / k))
    parts = [np.stack([rng.uniform(-1, 1, n_ground), rng.uniform(-1, 1, n_ground),
                       0.01 * rng.normal(size=n_ground)], axis=-1)]
    for cnt in counts:
        cls_id = int(rng.integers(0, N_SHAPES))
        scale = rng.uniform(0.15, 0.3)
        yaw = rng.uniform(0, 2 * math.pi)
        rot = np.array([[math.cos(yaw), -math.sin(yaw), 0.0],
                        [math.sin(yaw), math.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
        pts = shape_points(cls_id, rng, int(cnt)) @ rot.T * scale
        pts = pts + np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.8, 0.8), scale])
        parts.append(pts + 0.005 * rng.normal(size=pts.shape))
    cloud = np.concatenate(parts, axis=0)
    return cloud[rng.permutation(n)].astype(np.float32)


def make_cloud(traffic: dict, seed: int, index: int, n: int) -> np.ndarray:
    """Cloud `index` of the mix's pool: (n, 3) float32."""
    rng = rng_for(seed, STREAM_POOL, index)
    clouds = traffic["clouds"]
    if clouds["kind"] == "objects":
        return object_cloud(rng, n)
    if clouds["kind"] == "scenes":
        return scene_cloud(rng, n, tuple(clouds["shapes"]), clouds["ground"])
    raise ValueError(f"unknown cloud kind {clouds['kind']!r}")


def batch_pool(traffic: dict, seed: int, n_points: int) -> np.ndarray:
    """The closed loop's pool: (pool_batches, batch, n_points, 3) float32."""
    nb, b = traffic["pool_batches"], traffic["batch"]
    pool = np.empty((nb, b, n_points, 3), np.float32)
    for i in range(nb * b):
        pool[i // b, i % b] = make_cloud(traffic, seed, i, n_points)
    return pool


def cloud_sizes(traffic: dict, seed: int, count: int) -> np.ndarray:
    """`count` cloud sizes, log-uniform over the mix's [lo, hi] points."""
    lo, hi = traffic["clouds"]["points"]
    u = rng_for(seed, STREAM_SIZES).uniform(0.0, 1.0, count)
    return np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo)))).astype(np.int64)


def served_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    """The open loop's distinct clouds, of ragged sizes."""
    sizes = cloud_sizes(traffic, seed, traffic["pool_clouds"])
    return [make_cloud(traffic, seed, i, int(n)) for i, n in enumerate(sizes)]


def arrivals(traffic: dict, seed: int, seconds: float, rate: float | None = None) -> np.ndarray:
    """Due times (s from the window's start) of an open loop of bursts.

    The load repeats every `period_s`; each phase of it, (share of the
    period, multiple of the mean rate), sends round(rate * multiple * its
    length) requests at uniform random times within it (a Poisson process
    given its count), so every seed sends the same number of requests in
    each phase and only their spacing moves.
    """
    rate = traffic["rate"] if rate is None else rate
    period = traffic["period_s"]
    rng = rng_for(seed, STREAM_ARRIVALS)
    times = []
    start = 0.0
    while start < seconds - 1e-9:
        t0 = start
        for share, mult in traffic["phases"]:
            t1 = min(t0 + share * period, seconds)
            if t1 > t0:
                count = int(round(rate * mult * (t1 - t0)))
                times.append(np.sort(rng.uniform(t0, t1, count)))
            t0 += share * period
        start += period
    return np.concatenate(times) if times else np.zeros(0)


def request_order(seed: int, count: int, pool: int) -> np.ndarray:
    """Which pool cloud each request sends: the pool in a seeded order, again and again."""
    rng = rng_for(seed, STREAM_ORDER)
    reps = -(-count // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:count]
