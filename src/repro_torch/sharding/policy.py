"""Partitioning policies: how the LM's parameters, optimizer state, batches and
decode states lay out over a mesh, and how a serving replica over a device
group lays out its data (the replica specs).

The JAX package's `sharding/policy.py`, rule for rule: FSDP ("data") x TP
("model") x DP ("pod").  Under GSPMD any spec compiles to a correct
program, so the policy decides only where collectives appear and how much
memory a device holds.  Default rules (train):

  * a weight of 2+ free dims: the last dim that "model" divides goes over
    "model" (TP; the largest dim, padded, where none divides), and another
    dim that "data" divides over "data" (FSDP);
  * a leading stacked dim (a path through `blocks`, `enc_blocks`,
    `dec_blocks` or `rem`, on a leaf of 3+ dims) stays whole; an expert
    leaf `mlp/(wi|wg|wo)` (E, d, f) puts its experts over "model" (padded
    where E does not divide) and d over "data";
  * 1-D leaves (norm gains, biases) are replicated; "pod" is pure DP.

The rules read path keywords and leading stacked dims, so they run on the
reference's tree (the layers stacked, `params.lm_param_tree`), and
`module_pspecs` maps each spec onto the port's per-layer parameters by
dropping the stacked dim.  The reference's quirks stay: a stacked leaf of
two dims, such as mamba2's (L, H) `A_log`, is not taken for stacked (the
check wants 3+ dims), so its layer dim may go over "data".

Specs are `sharding.spec.PartitionSpec`; `to_shardings` binds them to a
mesh.  Trees are nested dicts, lists, tuples and NamedTuples of tensors
(meta tensors for a layout alone), mapped leaf by leaf with the path
string the reference's rules read.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple

import torch

from repro_torch.sharding.hints import REPLICA_AXIS
from repro_torch.sharding.spec import NamedSharding, PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """One partitioning policy: its name, FSDP on or off, and its batch axes.

    The tensor-parallel axis is always "model" and the FSDP axis "data".
    """

    name: str = "fsdp_tp"  # fsdp_tp | fsdp2d | tp_only | dp_only
    fsdp: bool = True  # shard a second weight dim over 'data'
    # batch sharding axes (pod first when present)
    data_axes: tuple[str, ...] = ("data",)

    def with_mesh(self, mesh) -> "ShardingPolicy":
        """The policy with the mesh's data axes: ("pod", "data") or ("data",)."""
        axes = tuple(mesh.axis_names)
        data_axes = ("pod", "data") if "pod" in axes else ("data",)
        return dataclasses.replace(self, data_axes=data_axes)


POLICIES = {
    "fsdp_tp": ShardingPolicy("fsdp_tp", fsdp=True),
    "fsdp2d": ShardingPolicy("fsdp2d", fsdp=True),  # batch over both axes, weights gathered
    "tp_only": ShardingPolicy("tp_only", fsdp=False),
    "dp_only": ShardingPolicy("dp_only", fsdp=False),
}


# path keywords that mark a leading STACKED dim (scan over groups/layers)
_STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks", "rem")
# leaf-name hints: first dim is an expert dim
_EXPERT_KEYS = ("wi", "wg", "wo")


def map_with_path(tree, fn, path: str = ""):
    """`tree` with every leaf (a tensor, a PartitionSpec, ...) replaced by fn(path,
    leaf); None stays None.

    The path joins dict keys and list or tuple positions with "/", and a
    NamedTuple field as ".name", as the reference's `_path_str` prints
    `jax.tree_util` keys.
    """
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(path, tree)
    join = (lambda k: f"{path}/{k}") if path else (lambda k: f"{k}")
    if isinstance(tree, dict):
        return type(tree)((k, map_with_path(v, fn, join(k))) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(v, fn, join(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(v, fn, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def _spec_for_weight(path: str, shape: tuple[int, ...], mesh, pol: ShardingPolicy, cfg) -> P:
    """Choose the PartitionSpec of one parameter leaf."""
    if pol.name == "dp_only" or len(shape) < 1:
        return P()
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")

    start = 0
    stacked = any(f"{k}" in path for k in _STACKED_KEYS)
    is_expert = (
        cfg is not None
        and cfg.n_experts > 0
        and re.search(r"mlp/(wi|wg|wo)$", path) is not None
        and ndim == 3
    )
    if is_expert:
        # (E, d, f): experts over 'model' (pads if not divisible), fsdp on dim1
        spec[0] = "model"
        if pol.fsdp and shape[1] % dsize == 0:
            spec[1] = "data"
        return P(*spec)
    if stacked and ndim >= 3:
        start = 1  # leading scan dim stays local
    dims = list(range(start, ndim))
    if len(dims) < 2:
        # 1D (norm/bias) or single free dim: replicate
        return P(*spec)

    # pick TP dim: prefer the LAST dim if divisible, else the largest divisible
    def divisible(i, size):
        return shape[i] % size == 0 and shape[i] >= size

    tp_dim = None
    for i in reversed(dims):
        if divisible(i, msize):
            tp_dim = i
            break
    if tp_dim is None:
        tp_dim = max(dims, key=lambda i: shape[i])  # pad-shard the largest
    spec[tp_dim] = "model"

    if pol.fsdp:
        for i in dims:
            if i != tp_dim and divisible(i, dsize):
                spec[i] = "data"
                break
    return P(*spec)


def param_pspecs(params_shape: Any, mesh, pol: ShardingPolicy, cfg=None):
    """The reference's parameter tree (tensors or meta tensors) -> a tree of PartitionSpecs."""
    pol = pol.with_mesh(mesh)
    return map_with_path(
        params_shape, lambda path, leaf: _spec_for_weight(path, tuple(leaf.shape), mesh, pol, cfg))


def state_pspecs(opt_state_shape: Any, param_specs: Any, mesh):
    """Optimizer state mirrors the param sharding (ZeRO-style: moments and
    master weights inherit the FSDP/TP layout); the step scalar replicates."""
    from repro_torch.optim.adamw import AdamWState

    master = param_specs if opt_state_shape.master is not None else None
    return AdamWState(step=P(), mu=param_specs, nu=param_specs, master=master)


def batch_pspecs(cfg, batch_shape: Any, mesh, pol: ShardingPolicy):
    """Batch dict: batch dim over (pod, data); seq/feature dims local."""
    pol = pol.with_mesh(mesh)
    daxes = pol.data_axes

    def fn(path, leaf):
        if leaf.ndim == 0:
            return P()
        b = leaf.shape[0]
        total = 1
        for a in daxes:
            total *= _axis_size(mesh, a)
        if pol.name == "fsdp2d":
            both = total * _axis_size(mesh, "model")
            if b % both == 0:
                return P(daxes + ("model",))
        if b % total == 0:
            return P(daxes) if leaf.ndim >= 1 else P()
        return P()  # unshardable batch (e.g. batch=1 long-context)

    return map_with_path(batch_shape, fn)


def decode_state_pspecs(cfg, state_shape: Any, mesh, pol: ShardingPolicy):
    """KV caches / recurrent states.

    Stacked KV leaves are (L, B, S, Hkv, Dh): batch over (pod,data) when
    divisible else seq over 'data'; kv-heads over 'model' when divisible
    else seq over 'model' (sequence-sharded decode)."""
    pol = pol.with_mesh(mesh)
    daxes = pol.data_axes
    dtotal = 1
    for a in daxes:
        dtotal *= _axis_size(mesh, a)
    msize = _axis_size(mesh, "model")

    def fn(p, leaf):
        if leaf.ndim == 0:
            return P()
        shape = leaf.shape
        spec: list[Any] = [None] * leaf.ndim
        if leaf.ndim >= 4:  # (L, B, S, H, D) or (B, S, H, D) or ssm (L,B,H,P,N)
            off = 1 if leaf.ndim == 5 else 0
            bdim, sdim, hdim = off, off + 1, off + 2
            if "state" in p and leaf.ndim == 5:  # ssm state (L,B,H,P,N)
                if shape[1] % dtotal == 0:
                    spec[1] = daxes
                if shape[2] % msize == 0:
                    spec[2] = "model"
                return P(*spec)
            if shape[bdim] % dtotal == 0:
                spec[bdim] = daxes
            elif shape[sdim] % _axis_size(mesh, "data") == 0:
                spec[sdim] = "data"
            if shape[hdim] % msize == 0:
                spec[hdim] = "model"
            elif spec[sdim] is None and shape[sdim] % msize == 0:
                spec[sdim] = "model"
            return P(*spec)
        if leaf.ndim >= 2:
            # recurrent/conv states (L,B,W) / (B,W) etc: batch over data, width over
            # model; a batch-sized dim found heuristically: the first dim divisible
            # by dtotal
            for i in range(leaf.ndim - 1):
                if shape[i] % dtotal == 0:
                    spec[i] = daxes
                    break
            if shape[-1] % msize == 0:
                spec[-1] = "model"
            return P(*spec)
        return P()

    return map_with_path(state_shape, fn)


def to_shardings(spec_tree: Any, mesh):
    """PartitionSpec leaves -> NamedShardings (idempotent on Shardings)."""
    return map_with_path(spec_tree, lambda path, s: s if isinstance(s, NamedSharding)
                         else NamedSharding(mesh, s))


def module_pspecs(module: torch.nn.Module, spec_tree) -> dict:
    """{port parameter name: spec} of an LM module, from the specs of its reference
    tree (`param_pspecs` of `params.lm_param_tree(module)`).

    A layer of a stacked ModuleList takes its stacked leaf's spec without
    the first (stacked) entry; the hybrid's `rem` layers, unstacked in the
    reference too, take theirs as they are.  A spec that splits the stacked
    dim (the two-dim quirk in the module docstring) spreads whole layers
    over the axis, which a per-layer tensor cannot show: that entry is
    dropped with the dim.  NamedShardings stay bound to their mesh.
    """
    from repro_torch.params import lm_layout, lm_leaf_key, named_jax_params

    layout = lm_layout(module.cfg)
    out = {}
    for name in named_jax_params(module):
        path, group = lm_leaf_key(name, layout)
        node = spec_tree
        for part in path:
            node = node[part]
        if group is not None:
            if isinstance(node, NamedSharding):
                node = NamedSharding(node.mesh, P(*node.spec[1:]))
            else:
                node = P(*node[1:])
        out[name] = node
    return out


# -- PC2IM serving: one replica spanning a device group ----------------------

REPLICA_SHARDING_MODES = ("batch", "tensor")


class ReplicaSpecs(NamedTuple):
    """Along which axis each of (params, points, logits) is split over a replica group.

    None means replicated: every shard holds all of it.  REPLICA_AXIS on a
    tensor means its leading (batch) dim is split in contiguous row blocks,
    shard i holding block i.
    """

    params: str | None
    points: str | None
    logits: str | None


def replica_specs(mode: str) -> ReplicaSpecs:
    """(params, points, logits) layout of one sharded replica under `mode`.

    The contract of the reference's `replica_specs`:

      * params are replicated: each device of the group holds a full copy;
      * the points' batch dim is split over the group in both modes.
        "batch" keeps it split end to end (each device runs the whole
        pipeline on its rows); "tensor" preprocesses the local rows, then
        gathers the neighbourhoods so that the feature MLPs can split every
        weight's columns over the group (the split-concatenate dataflow),
        inside the shard's body, so the boundary layout is the same;
      * the logits leave split by rows, and the caller reassembles the batch.

    Raises ValueError for a mode not in REPLICA_SHARDING_MODES.
    """
    if mode not in REPLICA_SHARDING_MODES:
        raise ValueError(
            f"sharding mode must be one of {REPLICA_SHARDING_MODES}, got {mode!r}"
        )
    return ReplicaSpecs(params=None, points=REPLICA_AXIS, logits=REPLICA_AXIS)
