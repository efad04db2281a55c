"""ExecutionPolicy — one explicit, hashable description of HOW to run.

PC2IM is one accelerator with two coupled halves: the CIM preprocessing
dataflow (MSP / FPS / lattice query) and the split-concatenate SC-CIM
feature engine (quantized MLP MACs).  Both halves read the numeric mode and
the kernel backend from the same object:

    policy = ExecutionPolicy(quant="sc_w16a16")
    accel = get_accelerator(cfg, policy)

Backends in this package: None, "auto" and "pallas" all mean "the
hand-written CUDA kernel for CUDA tensors, the plain PyTorch version for
CPU tensors"; "pallas" keeps its name so a policy reads the same in both
packages.  "xla" selects the plain version, which is only allowed on the
CPU: on a CUDA tensor it raises, since the port has one GPU path.

The policy is passed functionally (no thread-local or module state) and is
frozen, so it keys the engine and accelerator caches directly.  `interpret`
and `precision` are carried so that a policy has the same fields and hash
identity as in the JAX package.  `pipeline="pipelined"` selects the
two-stream executor of `infer_pipelined` and of a serving replica, and
`sharding` the split of a replica's batch over its device group
(`PC2IMAccelerator.mesh_artifacts`); every entry point of one device runs
a sharded policy's unsharded math.
"""

from __future__ import annotations

import dataclasses

from repro_torch.sharding.policy import REPLICA_SHARDING_MODES

QUANT_MODES = ("none", "sc_w16a16", "sc_w8a8")
PIPELINE_MODES = ("sequential", "pipelined")
SHARDING_MODES = (None, *REPLICA_SHARDING_MODES)
_QUANT_BITS = {"sc_w16a16": 16, "sc_w8a8": 8}


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How to execute — orthogonal to WHAT to execute (the model config).

    quant     : numeric mode for every dense layer — "none" (float) or the
                paper's C4 SC-CIM integer paths "sc_w16a16" / "sc_w8a8".
    backend   : kernel backend ("auto" | "pallas" | "xla") used by BOTH
                halves: preprocessing kernels (FPS, lattice) and the SC
                integer matmul behind quantized linears.  None defers to the
                config's pinned preproc_backend.
    interpret : carried for parity with the JAX package; no meaning here.
    precision : reserved knob (matmul precision), carried for hash identity.
    sharding  : None | "batch" | "tensor": how a replica over a device group
                splits a batch (`MeshArtifacts`): "batch" gives each device
                its rows and makes the SC activation scale global, "tensor"
                also splits every weight's columns over the group.  Inert
                outside a group; mutually exclusive with "pipelined".
    pipeline  : "sequential" | "pipelined": the accelerator's fused forward,
                or the two-stream preprocess/feature executor.
    """

    quant: str = "none"
    backend: str | None = None
    interpret: bool | None = None
    precision: str = "default"
    sharding: str | None = None
    pipeline: str = "sequential"

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {self.quant!r}")
        if self.backend not in (None, "auto", "pallas", "xla"):
            raise ValueError(
                f"backend must be None, 'auto', 'pallas' or 'xla', got {self.backend!r}"
            )
        if self.pipeline not in PIPELINE_MODES:
            raise ValueError(
                f"pipeline must be one of {PIPELINE_MODES}, got {self.pipeline!r}"
            )
        if self.sharding not in SHARDING_MODES:
            raise ValueError(
                f"sharding must be one of {SHARDING_MODES}, got {self.sharding!r}"
            )
        if self.sharding is not None and self.pipeline == "pipelined":
            raise ValueError(
                "sharding and pipeline='pipelined' are mutually exclusive, "
                "as in the JAX package"
            )

    @property
    def quant_bits(self) -> int | None:
        """Operand width of the SC integer path (None in float mode)."""
        return _QUANT_BITS.get(self.quant)

    def resolved_backend(self, default: str = "auto") -> str:
        """Backend with the None placeholder resolved (config default wins)."""
        return self.backend if self.backend is not None else default


DEFAULT_POLICY = ExecutionPolicy()


def policy_for(cfg) -> ExecutionPolicy:
    """Default policy of a model config.

    Reads the config's declared numeric mode (`cfg.quant`) and its
    preprocessing backend (`cfg.preproc_backend`), which then applies to the
    whole pipeline: preprocessing AND the SC feature path.
    """
    return ExecutionPolicy(
        quant=getattr(cfg, "quant", "none"),
        backend=getattr(cfg, "preproc_backend", "auto"),
    )


def resolve_policy(cfg, policy: ExecutionPolicy | None) -> ExecutionPolicy:
    """Resolve a caller-supplied policy against a config, once, at the entry point.

    None -> the config's default policy.  backend=None -> the config's
    pinned backend (preproc_backend, else "auto"), so both halves see the
    same concrete backend decision.
    """
    if policy is None:
        return policy_for(cfg)
    if policy.backend is None:
        return dataclasses.replace(
            policy, backend=getattr(cfg, "preproc_backend", "auto")
        )
    return policy
