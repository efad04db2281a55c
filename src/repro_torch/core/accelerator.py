"""PC2IMAccelerator — one (config, policy, device) triple -> the whole PC2IM pipeline.

The paper's accelerator is ONE device: the CIM preprocessing dataflow
(MSP -> L1 FPS -> lattice query) and the SC-CIM feature engine (quantized
per-point MLPs) are co-scheduled halves of the same chip.  A
`PC2IMAccelerator` owns the per-SA-stage `PreprocessEngine`s and the
policy-driven feature path, and exposes `infer` / `forward` and the two
halves on their own:

    accel = get_accelerator(get_config("pointnet2-cls"),
                            ExecutionPolicy(quant="sc_w16a16"))   # on "cuda"
    params = accel.init(torch.Generator().manual_seed(0))
    logits = accel.infer(params, points)        # (B, N, 3+F) -> (B, C)

The same holds for `get_config("pointnet2-seg")`, whose logits are per
point: (B, N, 3+F) -> (B, N, C).

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, which runs the plain versions of the kernels).  Without a
card the default device raises: nothing drifts to the CPU.  PyTorch runs
eagerly, so there is nothing to compile; the cache keys one accelerator per
(config, policy, device) so every caller of a triple shares its engines.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models import pointnet2 as PN


class PC2IMAccelerator:
    """The PC2IM pipeline for one (PointNet2Config, ExecutionPolicy, device).

    Attributes:
        config  : the model/architecture description (WHAT to run).
        policy  : the execution description (HOW to run), resolved.
        device  : where inputs are placed and every kernel runs.
        engines : per-SA-stage PreprocessEngines, stage i consuming stage
                  i-1's centroid count.
    """

    def __init__(self, config: PN.PointNet2Config, policy: ExecutionPolicy | None = None,
                 device=None):
        PN.check_ported(config)
        self.config = config
        self.policy = resolve_policy(config, policy)
        self.device = resolve_device(device)
        engines = []
        n = config.n_points
        for sa in config.sa:
            engines.append(PN.stage_engine(config, sa, n, self.policy))
            n = sa.n_centroids
        self.engines = tuple(engines)

    def init(self, generator: torch.Generator | None = None) -> PN.PointNet2Params:
        """Fresh parameters on this accelerator's device (drawn on the CPU from `generator`)."""
        return PN.init_params(self.config, generator, device=self.device)

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32, device=self.device)

    def forward(self, params: PN.PointNet2Params, points) -> torch.Tensor:
        """Batched forward, autograd on: (B, N, 3+F) -> logits.

        Logits are (B, n_classes) for a cls config and (B, N, n_classes),
        one row a point, for a seg config.
        """
        return PN.forward(params, self.config, self._points(points), policy=self.policy)

    def infer(self, params: PN.PointNet2Params, points) -> torch.Tensor:
        """Inference entry point: `forward` under torch.inference_mode().

        (B, N, 3+F) -> (B, n_classes) for cls, (B, N, n_classes) for seg.
        """
        with torch.inference_mode():
            return self.forward(params, points)

    def preprocess_stage(self, points) -> tuple:
        """Params-free preprocessing half, one PreprocessResult per SA stage.

        Chains MSP partition + FPS + lattice query stage after stage; reads
        only coordinates.
        """
        with torch.inference_mode():
            return PN.preprocess_stage(self.config, self._points(points), policy=self.policy)

    def feature_stage(self, params: PN.PointNet2Params, points, preproc: tuple) -> torch.Tensor:
        """Feature half: SC-CIM (or float) per-point MLPs + aggregation, and for
        seg the feature-propagation stages (3-NN interpolation + MLPs).

        `feature_stage(params, pts, preprocess_stage(pts))` equals
        `infer(params, pts)`: `forward` is exactly that composition.
        """
        with torch.inference_mode():
            return PN.feature_stage(
                params, self.config, self._points(points), preproc, policy=self.policy
            )

    def __repr__(self) -> str:
        return (
            f"PC2IMAccelerator({self.config.name}, quant={self.policy.quant!r}, "
            f"backend={self.policy.backend!r}, device={str(self.device)!r}, "
            f"stages={len(self.engines)})"
        )


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Snapshot of the accelerator cache (see `cache_stats`).

    hits/misses count `get_accelerator` calls; size is the number of live
    accelerators; keys names each as (config.name, quant, backend, pipeline,
    sharding, device).
    """

    hits: int
    misses: int
    size: int
    keys: tuple[tuple[str, str, str | None, str, str | None, str], ...]


# A dict under a lock rather than lru_cache: concurrent misses on one key
# must construct one accelerator, not two.
_lock = threading.Lock()
_artifacts: dict[tuple, PC2IMAccelerator] = {}
_hits = 0
_misses = 0


def get_accelerator(config: PN.PointNet2Config, policy: ExecutionPolicy | None = None,
                    device=None) -> PC2IMAccelerator:
    """Accelerator cache: one pipeline per (config, policy, device).

    The policy is resolved against the config and the device resolved
    ("cuda" by default) before keying the cache, so equivalent requests share
    one accelerator.  Thread-safe.
    """
    global _hits, _misses
    key = (config, resolve_policy(config, policy), resolve_device(device))
    with _lock:
        accel = _artifacts.get(key)
        if accel is None:
            _misses += 1
            accel = _artifacts[key] = PC2IMAccelerator(*key)
        else:
            _hits += 1
        return accel


def cache_stats() -> CacheStats:
    """Introspect the accelerator cache (hit/miss counters + live keys)."""
    with _lock:
        keys = tuple(
            (cfg.name, pol.quant, pol.backend, pol.pipeline, pol.sharding, str(dev))
            for cfg, pol, dev in _artifacts
        )
        return CacheStats(hits=_hits, misses=_misses, size=len(_artifacts), keys=keys)


def clear_cache() -> None:
    """Drop every cached accelerator and reset the hit/miss counters."""
    global _hits, _misses
    with _lock:
        _artifacts.clear()
        _hits = 0
        _misses = 0
