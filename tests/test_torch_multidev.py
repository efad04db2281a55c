"""Port parity, the multi-device schedule and the cross-pod compression on the CPU:

  * `parallel.pipeline.pipeline_forward` (GPipe fill-drain over 4 stage
    devices) against the JAX package's, which runs in a child process with
    4 forced host devices (tests/_multidev.py): within 2e-5, the JAX
    test's own tolerance (the two packages' matmuls sum in different
    orders, and the reference adds the other stages' zeros with a psum);
  * against the sequential composition of the stages on the same devices:
    bitwise (the same ops, only reordered in time);
  * `optim.compression` against the JAX package on the same numpy
    gradients over several steps with error feedback: bitwise, int8 values,
    scales, residuals and the decompressed gradients alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _multidev import run_in_child
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.optim import compression as j_compression
from repro_torch.optim import compression as t_compression
from repro_torch.parallel import pipeline_forward

jax.config.update("jax_platform_name", "cpu")

N_STAGES, N_MICRO = 4, 8


def _stage(wp, xx, stage):
    return torch.tanh(xx @ wp)


def _sequential(w, x):
    ref = x
    for s in range(w.shape[0]):
        ref = _stage(w[s], ref, s)
    return ref


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX package's 4-stage pipeline on 4 forced host devices, fed numpy inputs."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N_STAGES, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, 4, 16)).astype(np.float32)
    payload = run_in_child(
        f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.parallel import pipeline_forward

        mesh = jax.make_mesh((4,), ("stage",))
        w = jnp.asarray(np.array({w.tolist()!r}, np.float32))
        x = jnp.asarray(np.array({x.tolist()!r}, np.float32))
        emit("w", w)
        emit("x", x)
        emit("out", pipeline_forward(mesh, "stage", lambda wp, xx, s: jnp.tanh(xx @ wp), w, x))
        """,
        n_devices=4,
    )
    np.testing.assert_array_equal(payload["w"], w)
    np.testing.assert_array_equal(payload["x"], x)
    return w, x, payload["out"]


def test_pipeline_forward_matches_the_jax_package(jax_pipeline):
    w, x, want = jax_pipeline
    got = pipeline_forward(["cpu"] * N_STAGES, _stage, torch.from_numpy(w), torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_stages,n_micro", [(1, 3), (2, 5), (4, 8), (4, 2)])
def test_pipeline_forward_equals_the_sequential_composition(n_stages, n_micro):
    rng = np.random.default_rng(n_stages * 10 + n_micro)
    w = torch.from_numpy((rng.standard_normal((n_stages, 32, 32)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n_micro, 6, 32)).astype(np.float32))
    got = pipeline_forward(["cpu"] * n_stages, _stage, w, x)
    assert torch.equal(got, _sequential(w, x))


def test_pipeline_forward_takes_a_params_tree():
    """A dict of stacked leaves: stage s gets {k: v[s]}."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 2, 8)).astype(np.float32))
    got = pipeline_forward(["cpu"] * 3, lambda p, xx, s: torch.relu(xx @ p["w"] + p["b"]),
                           {"w": w, "b": b}, x)
    want = x
    for s in range(3):
        want = torch.relu(want @ w[s] + b[s])
    assert torch.equal(got, want)


def _grads(rng):
    return {"a/w": (rng.standard_normal((7, 5)) * 1e-2).astype(np.float32),
            "a/b": rng.standard_normal(5).astype(np.float32),
            "z": np.zeros((3,), np.float32),
            "big": (rng.standard_normal((4, 4, 4)) * 1e4).astype(np.float32)}


def test_compression_matches_the_jax_package_bitwise():
    """Four steps of compress -> decompress with error feedback carried in both."""
    rng = np.random.default_rng(0)
    shapes = _grads(rng)
    j_err = j_compression.init_error_feedback({k: jnp.asarray(v) for k, v in shapes.items()})
    t_err = t_compression.init_error_feedback({k: torch.from_numpy(v) for k, v in shapes.items()})
    for step in range(4):
        g = _grads(rng)
        jc, j_err = j_compression.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, j_err)
        tc, t_err = t_compression.compress_grads({k: torch.from_numpy(v) for k, v in g.items()},
                                                 t_err)
        j_dec = j_compression.decompress_grads(jc)
        t_dec = t_compression.decompress_grads(tc)
        for k in g:
            assert tc.q[k].dtype == torch.int8 and tc.scale[k].dtype == torch.float32
            np.testing.assert_array_equal(tc.q[k].numpy(), np.asarray(jc.q[k]), err_msg=k)
            np.testing.assert_array_equal(tc.scale[k].numpy(), np.asarray(jc.scale[k]), err_msg=k)
            np.testing.assert_array_equal(t_err[k].numpy(), np.asarray(j_err[k]), err_msg=k)
            np.testing.assert_array_equal(t_dec[k].numpy(), np.asarray(j_dec[k]), err_msg=k)


def test_error_feedback_starts_at_zero_beside_each_parameter():
    from repro_torch.configs import get_config
    from repro_torch.models.pointnet2 import init_params
    from repro_torch.params import named_jax_params

    params = init_params(get_config("pointnet2-cls", smoke=True), torch.Generator().manual_seed(0),
                         device="cpu")
    err = t_compression.init_error_feedback(params)
    named = named_jax_params(params)
    assert err.keys() == named.keys()
    assert all(torch.equal(err[k], torch.zeros_like(named[k])) for k in named)
