"""Port parity, data: repro_torch.data.pointclouds against the JAX package's
data/pointclouds.py.

The two packages draw from different generators, so the geometry is held
against the reference by feeding the port's `batch_from_draws` the JAX
package's own draws, split from the key as `sample_batch` splits it
(`pointclouds.py:73-76` and `_make_shape`'s three keys).

Tolerances and why:
  * points, atol 1e-5: the rotation comes from LAPACK's QR in both packages
    and the scaled rotation is a 3-term dot product, each summed in its own
    order (float32 rounding, ~1e-7 on coordinates of magnitude ~1.3);
  * class labels equal; seg labels equal except for a point within 1e-6 of
    an octant plane of the canonical frame, where the float rounding of the
    two packages may fall on either side of zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.data import pointclouds as JD
from repro_torch.data import pointclouds as TD

jax.config.update("jax_platform_name", "cpu")

N = 256
POINTS_ATOL = 1e-5


def _jax_draws(key, batch, n):
    """The reference's draws for one sample_batch(key, batch, n) call, split as it splits."""
    out = {k: [] for k in ("cls", "u", "t", "normal", "a", "scale", "jitter")}
    for k in jax.random.split(key, batch):
        kc, ks, kr, kj, kscale = jax.random.split(k, 5)
        k1, k2, k3 = jax.random.split(ks, 3)
        out["cls"].append(jax.random.randint(kc, (), 0, JD.N_CLASSES))
        out["u"].append(jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0))
        out["t"].append(jax.random.uniform(k2, (n,), minval=0.0, maxval=1.0))
        out["normal"].append(jax.random.normal(k3, (n, 3)))
        out["a"].append(jax.random.normal(kr, (3, 3)))
        out["scale"].append(jax.random.uniform(kscale, (), minval=0.7, maxval=1.3))
        out["jitter"].append(jax.random.normal(kj, (n, 3)))
    return {k: torch.from_numpy(np.stack([np.array(v) for v in vs])) for k, vs in out.items()}


def _canonical(draws, cls_ids):
    shapes = TD.make_shapes(draws["u"], draws["t"], draws["normal"])
    return shapes[torch.arange(len(cls_ids)), torch.from_numpy(np.array(cls_ids))]


@pytest.fixture(scope="module")
def reference():
    """A batch big enough to hold all 8 classes, from the JAX package and its draws."""
    key = jax.random.PRNGKey(0)
    batch = 32
    pts, cls, seg = JD.sample_batch(key, batch, N)
    draws = _jax_draws(key, batch, N)
    return (np.asarray(pts), np.asarray(cls), np.asarray(seg)), draws


def test_reference_batch_covers_every_class(reference):
    (_, cls, _), draws = reference
    assert sorted(set(cls.tolist())) == list(range(TD.N_CLASSES))
    np.testing.assert_array_equal(draws["cls"].numpy(), cls)


def test_geometry_fed_jax_draws_equals_sample_batch(reference):
    (pts, cls, seg), d = reference
    got_pts, got_cls, got_seg = TD.batch_from_draws(
        d["cls"], d["u"], d["t"], d["normal"], d["a"], d["scale"], d["jitter"])
    assert got_pts.dtype == torch.float32 and got_cls.dtype == got_seg.dtype == torch.int64
    np.testing.assert_array_equal(got_cls.numpy(), cls)
    for c in range(TD.N_CLASSES):
        rows = cls == c
        np.testing.assert_allclose(got_pts.numpy()[rows], pts[rows], rtol=0, atol=POINTS_ATOL,
                                   err_msg=f"class {c}")
    canon = _canonical(d, cls).numpy()
    near_plane = (np.abs(canon) < 1e-6).any(axis=-1)
    differ = got_seg.numpy() != seg
    assert not (differ & ~near_plane).any()


@pytest.mark.parametrize("cls_id", range(TD.N_CLASSES))
def test_each_shape_equals_make_shape(cls_id):
    key = jax.random.PRNGKey(10 + cls_id)
    want = np.asarray(JD._make_shape(cls_id, key, N))
    k1, k2, k3 = jax.random.split(key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(k1, (N, 3), minval=-1.0, maxval=1.0)))
    t = torch.from_numpy(np.array(jax.random.uniform(k2, (N,), minval=0.0, maxval=1.0)))
    normal = torch.from_numpy(np.array(jax.random.normal(k3, (N, 3))))
    got = TD.make_shapes(u, t, normal)[cls_id].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=POINTS_ATOL)


def test_rotation_equals_reference():
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        a = np.asarray(jax.random.normal(key, (3, 3)))
        want = np.asarray(JD._random_rotation(key))
        got = TD.rotation_from_gaussian(torch.from_numpy(a.copy())[None])[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=POINTS_ATOL)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(got) - 1.0) < 1e-5


def test_sample_batch_on_the_cpu_is_seeded_and_well_formed():
    a = TD.sample_batch(5, 4, N, device="cpu")
    b = TD.sample_batch(5, 4, N, device="cpu")
    c = TD.sample_batch(6, 4, N, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    pts, cls, seg = a
    assert pts.shape == (4, N, 3) and cls.shape == (4,) and seg.shape == (4, N)
    assert pts.device.type == "cpu" and torch.isfinite(pts).all()
    assert ((seg >= 0) & (seg < TD.N_SEG_CLASSES)).all()
    assert pts.abs().max() < 2.0


def test_stream_is_restart_exact_and_covers_every_class():
    stream = TD.data_stream(7, 8, 64, device="cpu")
    first = [next(stream) for _ in range(6)]
    again = TD.data_stream(7, 8, 64, device="cpu")
    for want in first:
        got = next(again)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # step s draws from (seed, s, shard) alone: a resumed stream reproduces it
    resumed = TD.sample_batch(TD.fold_in(7, 4, 0), 8, 64, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(resumed, first[4]))
    seen = set(torch.cat([b[1] for b in first]).tolist())
    assert seen == set(range(TD.N_CLASSES))


def test_shards_draw_disjoint_steps():
    s0 = TD.data_stream(1, 2, 32, shard_id=0, n_shards=2, device="cpu")
    s1 = TD.data_stream(1, 2, 32, shard_id=1, n_shards=2, device="cpu")
    a0, a1 = next(s0), next(s1)
    assert not torch.equal(a0[0], a1[0])
    b0 = next(s0)  # shard 0's second batch is step 2 of shard 0
    want = TD.sample_batch(TD.fold_in(1, 2, 0), 2, 32, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(b0, want))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.sample_batch(0, 2, 16)
