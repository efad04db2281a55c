"""Port parity, kernels: each plain PyTorch version against the JAX package's
Pallas kernel (interpret mode, tiny shapes) and XLA reference, bitwise; the
registry's device dispatch and launch counters; the CUDA wrappers' refusals
on the CPU; and the nvcc build's command line.  The CUDA kernels themselves
run only on a card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fps.ops import fps_tiles as j_fps_tiles
from repro.kernels.lattice.ops import lattice_query_tiles as j_lattice_tiles
from repro.kernels.sc_matmul.ops import sc_matmul_op as j_sc_matmul_op
from repro.kernels.sc_matmul.ops import sc_quantized_linear as j_sc_linear
from repro_torch.kernels import build, registry
from repro_torch.kernels.fps.kernel import fps_tiles_cuda
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.fps.ref import fps_tiles_plain
from repro_torch.kernels.lattice.kernel import lattice_tiles_cuda
from repro_torch.kernels.lattice.ops import lattice_query_tiles
from repro_torch.kernels.sc_matmul.kernel import sc_matmul_cuda
from repro_torch.kernels.sc_matmul.ops import sc_matmul_op, sc_quantized_linear

jax.config.update("jax_platform_name", "cpu")


def _tiles(t, p, seed=0, snapped=False):
    x = np.random.default_rng(seed).uniform(-1, 1, (t, p, 3)).astype(np.float32)
    return (np.round(x * 4) / 4).astype(np.float32) if snapped else x


# -- FPS ------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("snapped", [False, True])
def test_fps_plain_matches_pallas_interpret(metric, snapped):
    pts = _tiles(2, 128, seed=1, snapped=snapped)
    want = j_fps_tiles(jnp.asarray(pts), 8, metric=metric, backend="pallas", interpret=True)
    got = fps_tiles(torch.from_numpy(pts), 8, metric=metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("t,p,k", [(32, 64, 16), (3, 200, 12), (1, 5, 5)])
def test_fps_plain_matches_reference_any_tile_size(metric, t, p, k):
    """The port takes any P (no lane padding): same indices as the XLA reference."""
    pts = _tiles(t, p, seed=p, snapped=True)
    want = j_fps_tiles(jnp.asarray(pts), k, metric=metric, backend="xla")
    np.testing.assert_array_equal(fps_tiles_plain(torch.from_numpy(pts), k, metric=metric).numpy(),
                                  np.asarray(want))


# -- lattice ----------------------------------------------------------------------


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (1.5, 16)])
def test_lattice_plain_matches_pallas_interpret(radius, nsample):
    pts = _tiles(2, 128, seed=2, snapped=True)
    cents = pts[:, ::16].copy()
    want = j_lattice_tiles(jnp.asarray(pts), jnp.asarray(cents), radius, nsample,
                           backend="pallas", interpret=True)
    got = lattice_query_tiles(torch.from_numpy(pts), torch.from_numpy(cents), radius, nsample)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_lattice_plain_matches_reference_any_tile_size():
    pts = _tiles(5, 70, seed=3)
    cents = pts[:, :9].copy()
    want = j_lattice_tiles(jnp.asarray(pts), jnp.asarray(cents), 0.2, 32, backend="xla")
    got = lattice_query_tiles(torch.from_numpy(pts), torch.from_numpy(cents), 0.2, 32)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


# -- SC matmul ---------------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_plain_matches_pallas_interpret(bits):
    lim = 1 << (bits - 1)
    rng = np.random.default_rng(bits)
    x = rng.integers(-lim, lim, (16, 64), dtype=np.int32)
    w = rng.integers(-lim, lim, (64, 32), dtype=np.int32)
    want = j_sc_matmul_op(jnp.asarray(x), jnp.asarray(w), bits=bits, backend="pallas",
                          interpret=True)
    got = sc_matmul_op(torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("lead", [(40,), (2, 33)])
def test_sc_quantized_linear_bitwise(bits, lead):
    rng = np.random.default_rng(len(lead))
    x = rng.normal(size=lead + (19,)).astype(np.float32)
    w = (rng.normal(size=(19, 24)) * 0.1).astype(np.float32)
    want = j_sc_linear(jnp.asarray(x), jnp.asarray(w), bits=bits, backend="xla")
    got = sc_quantized_linear(torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    assert got.shape == lead + (24,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sc_matmul_op_rejects_bad_bits():
    with pytest.raises(ValueError):
        sc_matmul_op(torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32),
                     bits=10)


# -- registry: dispatch and launch counters -------------------------------------------


def test_registry_dispatch_by_device():
    x = torch.zeros(2, 4, 3)
    assert set(registry.names()) >= {"fps_tiles", "lattice_tiles", "sc_matmul"}
    for backend in (None, "auto", "pallas", "xla"):
        assert registry.dispatch("fps_tiles", x, backend) is fps_tiles_plain
    with pytest.raises(ValueError):
        registry.dispatch("fps_tiles", x, "cuda")
    with pytest.raises(KeyError):
        registry.dispatch("nope", x)
    with pytest.raises(ValueError):
        registry.dispatch("fps_tiles", torch.zeros(2, device="meta"))


def test_plain_versions_do_not_count_launches():
    registry.reset_launches()
    fps_tiles(torch.from_numpy(_tiles(2, 16)), 4)
    lattice_query_tiles(torch.from_numpy(_tiles(2, 16)), torch.zeros(2, 3, 3), 0.5, 4)
    assert registry.launches() == {name: 0 for name in registry.names()}
    registry.count_launch("fps_tiles")
    assert registry.launches()["fps_tiles"] == 1
    registry.reset_launches()
    assert registry.launches()["fps_tiles"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper checks every tensor before any pointer (or nvcc) is touched."""
    pts = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fps_tiles_cuda(pts, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lattice_tiles_cuda(pts, torch.zeros(2, 2, 3), nsample=4, l_range=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        sc_matmul_cuda(torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        registry.require_cuda_tensor(torch.zeros(3), "x", torch.float32, 1)


# -- build ------------------------------------------------------------------------------


def test_build_targets_hopper_without_fma_contraction(tmp_path):
    cmd = build.compile_command("fps", "nvcc", tmp_path / "fps.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert str(build.SRC_DIR / "fps.cu") in cmd and "-shared" in cmd
    sources = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
    assert sources == sorted(build.SOURCES)
    # one library per source and compiler, named by a hash of what built it
    a, b = build.library_path("fps", "nvcc"), build.library_path("fps", "/other/nvcc")
    assert a != b and a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert build.library_path("fps", "nvcc") == a
