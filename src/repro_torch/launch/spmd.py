"""One device's share of a partitioned LM cell: its collectives and its memory,
from the cell's step run once more on meta tensors laid out as DTensors.

The JAX package's dry run compiles each cell with GSPMD and reads one
device's program: the collectives XLA inserted (`collective_census`,
`hlo_analysis`) and its buffer assignment (`memory_analysis`).  PyTorch's
counterpart of GSPMD is DTensor: a tensor laid out over a `DeviceMesh` by
placements, whose every op picks a sharding strategy and inserts the
collectives that it needs to reach it.  Here the mesh is a fake world
(`fake_world`: a `torch.distributed` group on the "fake" backend, rank 0 of
the mesh's size, no card and no network), and every DTensor's local shard is
a meta tensor, so the step moves no data and computes nothing:

  1. `partitioned_cell` builds the parameters, the AdamW state, the batch
     and the decode state as DTensors by `sharding.policy` (each spec
     through `to_placements`) and the step that `launch.dryrun.build_cell`
     builds;
  2. `census` runs it under a dispatch mode that sees the local ops that
     DTensor runs on rank 0's shards: every `c10d_functional` collective by
     kind, with its operand bytes (one device's, as the reference's SPMD
     HLO is one device's program), and every new result storage, added to
     the live bytes and dropped when the storage dies;
  3. a loop that runs one iteration for all on meta (`core.accounting.loop`)
     scales its collectives by its repetitions, so the census equals running
     every iteration, as the reference's `hlo_analysis` scales a while body
     by its trip count; `collectives_raw` counts each such body once, and
     `while_trip_counts` lists the repetitions.

  4. one device's memory: the arguments' local storages, then every new
     result storage until it dies; the peak counts the arguments, as XLA's
     does.  Alias is what the reference donates (parameters and AdamW
     state in train, the decode state in decode); temp = peak - arguments
     - outputs + alias.  The port's decode writes new caches beside the old
     ones (it donates nothing), so its temp holds a second decode state.

What has no counterpart: `generated_code_size_in_bytes` (no code is
generated), `compile_s`, `hlo_bytes` and `cost_analysis` (`launch.dryrun`).

DTensor picks each op's layout greedily, where GSPMD propagates layouts
over the whole program, and some of the port's ops it cannot split.  What
is done about each, and where the two part:

  * GSPMD pads a dim that its axes do not divide (`shard_shape`, ceil
    division); DTensor splits it unevenly, `torch.chunk`'s way, so rank 0
    holds ceil(n / ways) rows (the padded block) and a later rank fewer.
    The census is rank 0's, so its bytes are the padded ones;
  * a spec that names two axes on one dim must name them in the mesh's
    order (DTensor shards mesh dim by mesh dim, the first the slowest):
    every spec of `sharding.policy` does; an axis of size 1 splits nothing;
  * the SC matmul (`core.accounting.kernel_call`) is one op with a matmul's
    four strategies (`_sc_matmul_sharding`), and its quantizer's amax over
    a split operand is the max all-reduce that DTensor inserts;
  * strategies of the census's own (`census_strategies`, in DTensor's
    propagator inside the census alone, and valid on meta shards alone):
    the attention's batched products (split as an einsum: DTensor's
    matmul flattens the batch dims), the embedding (the table gathered,
    the rows split by the batch), `gather` (never along its dim: DTensor's
    masked partial sums cannot be reduced for it), `index_copy` (the
    caches' write, onto the shard that holds the position, as GSPMD's
    dynamic-update-slice) and `new_zeros` / `new_empty` / ... (split where
    the source is, dim by dim);
  * layout rules of the census's own (`_Layout`), where the op after could
    not take DTensor's greedy choice; the model code knows none of them:
      - a torch function mode over the step: a product of equal-rank
        operands is the census's batched product; a zero pad is zero
        blocks concatenated on (some torch versions' DTensor pad loses a
        layout over two mesh axes); a norm's gain and bias and the
        RG-LRU's Lambda are gathered whole where the module takes them;
      - module hooks: a linear's rows are split by their leading dim
        alone, in and out (the gradient too), its bias gathered whole and
        added after; under a train step, each gradient's partial sums are
        reduced once, where autograd makes it (data parallelism's
        all-reduce);
      - the compound ops the models mark (`core.overrides.overridable`),
        taken by `_Layout.take`: flash attention's q, k and v with their
        partial sums reduced before its block slices; decode attention's
        softmax as max, exp and sum, partial over a cache split along its
        sequence, as GSPMD partitions it; the cross entropy's rows by the
        batch alone and the LM head whole; the SSD's inputs and output by
        the batch alone and A whole; the causal conv's taps and bias whole;
  * an op that DTensor still cannot run as its inputs are laid out (a view
    that splits a head dim its axis does not divide, say) runs on inputs
    made whole on one mesh axis after another, and an op it has no
    strategy for on whole inputs (`Census._dtensor_op`): the all-gathers
    and all-reduces that costs are counted, as GSPMD inserts them where it
    cannot partition, and each such op is listed under `replicated_ops`.
    A cell whose op cannot run even so fails.

The activation hints (`sharding.hints`) redistribute the residual stream to
the spec the reference imposes, as its sharding constraint does, and where
it imposes none, to its batch alone.

The layout is DTensor's greedy one with these rules, not GSPMD's: its
collective bytes are 0.39-26.7x the reference's on a (2, 4) mesh
(tests/test_torch_lm_collectives.py), an estimate of another partitioner's
traffic, neither a lower nor an upper bound on the reference's.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import weakref
from collections import defaultdict
from fractions import Fraction

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import accounting, overrides
from repro_torch.sharding import hints
from repro_torch.sharding.spec import PartitionSpec

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# collective op name (any of the functional namespaces) -> the reference's kind
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor", "c10d")
# functional-collective bookkeeping that moves nothing
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


# -- the fake world ----------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(mesh):
    """A `DeviceMesh` over a fake process group of mesh.size ranks, this process rank 0.

    `mesh` is a `launch.mesh.Mesh` (its axis names and sizes; its devices,
    if any, are not used).  The group is on the "fake" backend: a
    collective returns at once and moves nothing.  The mesh's device type is
    "cuda", whose collectives (NCCL's) DTensor's cost model prices when it
    picks a strategy; nothing is placed on a card.  A "cpu" mesh would
    replace every all-to-all by an all-gather (Gloo has none).  On exit the
    group is destroyed, whatever happened inside, so no later code sees an
    initialised process group.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        ranks = torch.arange(mesh.size).reshape(tuple(mesh.shape.values()))
        yield DeviceMesh("cuda", ranks, mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


# -- specs as placements -----------------------------------------------------------------------


def to_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements (one a mesh axis) of a tensor laid out by `spec` on `mesh`.

    A dim whose entry names axes (a, b) is `Shard(dim)` on each of those
    mesh axes, in the reference's major-to-minor order, which must be the
    mesh's; a mesh axis that no entry names, or of size 1 (a split over one
    device is none), is `Replicate()`.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    out = [Replicate() for _ in names]
    for dim in range(len(spec)):
        axes = spec.axes_of(dim)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {dim} are not in the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {names[i]!r} splits two dims")
            if mesh.shape[names[i]] > 1:
                out[i] = Shard(dim)
    return out


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """Rank 0's shard of a tensor of `shape` under `spec`: each split dim cut by its
    axes one after another, `torch.chunk`'s way (rank 0 takes ceil(n / ways))."""
    out = list(shape)
    for dim in range(len(spec)):
        for a in spec.axes_of(dim):
            out[dim] = -(-out[dim] // mesh.shape[a])
    return tuple(out)


def distribute_meta(t: torch.Tensor, spec: PartitionSpec, mesh, dmesh):
    """A DTensor of t's shape and dtype laid out by `spec`, its local shard (rank 0's)
    a new meta tensor."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
    stride = torch.empty(t.shape, dtype=t.dtype, device="meta").stride()
    return DTensor.from_local(local, dmesh, to_placements(spec, mesh), run_check=False,
                              shape=tuple(t.shape), stride=stride)


def _zip_map(tree, specs, fn):
    """`tree` with every tensor leaf replaced by fn(leaf, its spec in `specs`)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return type(tree)((k, _zip_map(v, specs[k], fn)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(v, s, fn) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(v, s, fn) for v, s in zip(tree, specs))
    return tree


def _local_tensors(tree) -> list[torch.Tensor]:
    """The local shards (plain tensors) of every tensor leaf of a tree or module."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local_tensors(v)]
    return []


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind `tensors`."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


# -- the cell, partitioned ---------------------------------------------------------------------


@dataclasses.dataclass
class PartitionedCell:
    """A cell's step over DTensors: `fn()` runs it; `args` are its arguments (the
    module, then the AdamW state and the batch, or the batch, or the decode state
    and the batch) and `donated` those the reference donates."""

    fn: object
    args: tuple
    donated: tuple


def partitioned_cell(cfg, kind: str, batch: dict, state, mesh, dmesh, policy_name: str,
                     microbatch: int | None = None, policy=None,
                     s_max: int | None = None) -> PartitionedCell:
    """The cell's parameters, AdamW state, batch and decode state as DTensors on
    `dmesh` by the policy's specs, and its step: the family's train step (with
    `microbatch`), `prefill` or one `decode_step` (`launch.dryrun.build_cell`'s fn).

    `batch` and `state` are meta tensors of the global shapes
    (`launch.shapes`); `policy` is the ExecutionPolicy of the step (None:
    the config's); `s_max` the prefill's cache length (None: the prompt's).
    """
    from repro_torch.launch import shapes as SH
    from repro_torch.models.families import get_family_api
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.params import lm_param_tree, named_jax_params
    from repro_torch.sharding import policy as POL

    pol = POL.POLICIES[policy_name].with_mesh(mesh)
    api = get_family_api(cfg)
    module = SH.abstract_module(cfg)
    tree_specs = POL.param_pspecs(lm_param_tree(module, device="meta"), mesh, pol, cfg)
    specs = POL.module_pspecs(module, tree_specs)

    def dist(t, spec):
        return distribute_meta(t, spec, mesh, dmesh)

    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, torch.nn.Parameter(dist(p, specs[name]),
                                              requires_grad=p.requires_grad))
    dbatch = _zip_map(batch, POL.batch_pspecs(cfg, batch, mesh, pol), dist)

    if kind == "train":
        from repro_torch.train.step import make_train_step

        named = named_jax_params(module)
        f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for k, p in named.items()}
        keep_master = any(p.dtype != torch.float32 for p in named.values())

        def moments():
            return {k: dist(t, specs[k]) for k, t in f32.items()}

        opt = AdamWState(step=dist(torch.empty((), dtype=torch.int32, device="meta"),
                                   PartitionSpec()),
                         mu=moments(), nu=moments(), master=moments() if keep_master else None)
        step = make_train_step(cfg, microbatch=microbatch, policy=policy)

        def fn():
            return step(module, opt, dbatch)
        return PartitionedCell(fn, (module, opt, dbatch), (module, opt))
    if kind == "prefill":
        def fn():
            with torch.no_grad():
                return api["prefill"](module, cfg, dbatch, s_max, policy=policy)
        return PartitionedCell(fn, (module, dbatch), ())
    dstate = _zip_map(state, POL.decode_state_pspecs(cfg, state, mesh, pol), dist)

    def fn():
        with torch.no_grad():
            return api["decode_step"](module, cfg, dstate, dbatch, policy=policy)
    return PartitionedCell(fn, (module, dstate, dbatch), (dstate,))


# -- the census's ops and the strategies it gives DTensor -----------------------------------

def _matmul_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.empty((*lead, a.shape[-2], b.shape[-1]), dtype=a.dtype, device=a.device)


def _sc_matmul_sharding(x, w, n_planes):
    """The SC matmul's strategies on one mesh axis, those of a matmul: rows, columns,
    the contracted dim (a partial sum) or nothing split."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [
        ([Shard(0)], [Shard(0), Replicate(), None]),
        ([Shard(1)], [Replicate(), Shard(1), None]),
        ([Partial()], [Shard(1), Shard(0), None]),
        ([Replicate()], [Replicate(), Replicate(), None]),
    ]


def _matmul_sharding(a, b):
    """A batched product (..., m, k) x (..., k, n) on one mesh axis, as an einsum
    splits: a batch dim (both alike, or the one that is not broadcast), the
    rows, the columns, or the contracted dim (partial sums)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    nd = len(a.shape)
    out = [([Replicate()], [Replicate(), Replicate()]),
           ([Shard(nd - 2)], [Shard(nd - 2), Replicate()]),
           ([Shard(nd - 1)], [Replicate(), Shard(nd - 1)]),
           ([Partial()], [Shard(nd - 1), Shard(nd - 2)])]
    for d in range(nd - 2):
        if a.shape[d] == b.shape[d]:
            out.append(([Shard(d)], [Shard(d), Shard(d)]))
        elif b.shape[d] == 1:
            out.append(([Shard(d)], [Shard(d), Replicate()]))
        elif a.shape[d] == 1:
            out.append(([Shard(d)], [Replicate(), Shard(d)]))
    return out


def _embedding_sharding(weight, indices, *args):
    """The embedding's strategies on one mesh axis: the table whole (gathered where
    it is split) and the output split as the token ids are, so that the residual
    stream starts out laid out by the batch as the hints keep it."""
    from torch.distributed.tensor import Replicate, Shard

    extra = [None] * len(args)
    out = [([Replicate()], [Replicate(), Replicate(), *extra])]
    for d in range(len(indices.shape)):
        out.append(([Shard(d)], [Replicate(), Shard(d), *extra]))
    return out


def _gather_sharding(x, dim, index, *args):
    """`gather` along `dim` on one mesh axis: both split alike on another dim, or
    whole.  (DTensor's own rule splits x along `dim` into masked partial sums,
    which it cannot reduce for a gather's output.)"""
    from torch.distributed.tensor import Replicate, Shard

    extra = [None] * len(args)
    dim = dim % len(x.shape)
    out = [([Replicate()], [Replicate(), None, Replicate(), *extra])]
    for d in range(len(x.shape)):
        if d != dim:
            out.append(([Shard(d)], [Shard(d), None, Shard(d), *extra]))
    return out


def _index_copy_sharding(x, dim, index, source):
    """`index_copy` along `dim` (the KV caches' write) on one mesh axis: x and the
    source split alike on another dim; x split along `dim` itself with the
    source whole, the write landing on the shard that holds its position (as
    GSPMD partitions a dynamic-update-slice: no collective; meta shards hold
    no values, so the index is not rebased); or all whole.  (DTensor
    decomposes it into a write into a new whole tensor otherwise.)"""
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % len(x.shape)
    out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()]),
           ([Shard(dim)], [Shard(dim), None, Replicate(), Replicate()])]
    for d in range(len(x.shape)):
        if d != dim:
            out.append(([Shard(d)], [Shard(d), None, Replicate(), Shard(d)]))
    return out


def _new_factory_sharding(x, size, *args, **kwargs):
    """`new_zeros` / `new_empty` / ... of `size` from x, on one mesh axis: split on a
    dim that x splits where the two sizes agree there, else whole.  (DTensor's own
    rule keeps x's split only where the whole shapes agree, so a gather's
    backward, zeros like its input, would be whole on every device.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    extra = [None] * (1 + len(args))
    out = []
    for d in range(len(x.shape)):
        kept = d < len(size) and x.shape[d] == size[d]
        out.append(([Shard(d) if kept else Replicate()], [Shard(d), *extra]))
    out.append(([Replicate()], [Partial(), *extra]))
    out.append(([Replicate()], [Replicate(), *extra]))
    return out


_OPS_DEFINED = False


def _define_ops() -> None:
    """Define the census's own ops, the SC matmul and the batched product, as
    torch.library ops with a fake (shape-only) body: once a process, as the
    library keeps them."""
    global _OPS_DEFINED
    if _OPS_DEFINED:
        return

    @torch.library.custom_op("repro_torch_spmd::sc_matmul", mutates_args=())
    def sc_matmul(x: torch.Tensor, w: torch.Tensor, n_planes: int) -> torch.Tensor:
        return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)

    @sc_matmul.register_fake
    def _(x, w, n_planes):
        return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)

    @torch.library.custom_op("repro_torch_spmd::batched_matmul", mutates_args=())
    def batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _matmul_out(a, b)

    batched_matmul.register_fake(_matmul_out)
    _OPS_DEFINED = True


# the tables of DTensor's sharding propagator that hold an op's strategy and what
# part of its arguments keys the propagator's cache
_PROP_TABLES = ("op_to_rules", "op_strategy_funcs", "op_single_dim_strategy_funcs",
                "op_to_schema_info", "op_to_schema_info_for_single_dim_strategy")
_ABSENT = object()


# the census's own cache of DTensor's propagation results, kept from census to census
# (its strategies are the same in each), in place of the propagator's own inside one
_CACHE = None


def _clear_fast_path_cache() -> None:
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:
        clear()


@contextlib.contextmanager
def census_strategies():
    """The census's strategies in DTensor's sharding propagator inside the block:
    its own ops' (the SC matmul, the batched product) and, in place of DTensor's,
    those of the embedding, `gather`, `index_copy` and `new_*`.  They hold for
    meta shards only (`_index_copy_sharding` does not rebase its index), so on
    exit every table entry of those ops is put back as it was, the
    propagator's cache of results is its own again (the census keeps its own,
    `_CACHE`) and its C++ cache is cleared: no DTensor program after the
    census sees them."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    _define_ops()
    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    factories = (aten.new_zeros.default, aten.new_empty.default, aten.new_ones.default,
                 aten.new_full.default)
    rules = [(torch.ops.repro_torch_spmd.sc_matmul.default, _sc_matmul_sharding),
             (torch.ops.repro_torch_spmd.batched_matmul.default, _matmul_sharding),
             (aten.embedding.default, _embedding_sharding),
             (aten.gather.default, _gather_sharding),
             (aten.index_copy.default, _index_copy_sharding)]
    rules += [(op, _new_factory_sharding) for op in factories]
    tables = [getattr(prop, t) for t in _PROP_TABLES if hasattr(prop, t)]
    saved = [(table, op, table.get(op, _ABSENT)) for table in tables for op, _ in rules]
    global _CACHE
    own_cache = prop.propagate_op_sharding
    if _CACHE is None:
        _CACHE = type(own_cache)(prop.propagate_op_sharding_non_cached)
    try:
        prop.propagate_op_sharding = _CACHE
        for op, rule in rules:
            # a rule of torch's own in its single-dim table would be taken before ours
            getattr(prop, "op_single_dim_strategy_funcs", {}).pop(op, None)
            register_sharding(op)(rule)
        for op in factories:  # the size (arg 1) and dtype decide the output: in the cache key
            prop.op_to_schema_info[op] = RuntimeSchemaInfo(1, ["dtype"], needs_pytree=True)
        _clear_fast_path_cache()
        yield
    finally:
        for table, op, entry in saved:
            if entry is _ABSENT:
                table.pop(op, None)
            else:
                table[op] = entry
        prop.propagate_op_sharding = own_cache
        _clear_fast_path_cache()


# -- the census --------------------------------------------------------------------------------


def _collective_kind(func) -> str | None:
    ns = getattr(func, "namespace", None) or func.__module__
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name in _NOT_COLLECTIVES:
        return None
    if name not in _KIND_OF:
        raise NotImplementedError(f"collective {func} has no census kind")
    return _KIND_OF[name]


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _flat(args, kwargs) -> list:
    from torch.utils._pytree import tree_leaves

    return tree_leaves((args, kwargs))


def _number(v: Fraction):
    return int(v) if v.denominator == 1 else float(v)


class Census(TorchDispatchMode):
    """Collectives and live storage bytes of the local ops DTensor runs (rank 0's).

    Also the `core.accounting` hooks' counter: `repeated(n)` scales the
    collectives inside by n, and `kernel_call` runs the SC matmul as one
    sharded op.
    """

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        from torch.distributed.tensor import Replicate

        self._fake, self._dtensor, self._replicate = FakeTensor, DTensor, Replicate
        self.scale = Fraction(1)
        self.collectives = {k: {"count": Fraction(0), "bytes": Fraction(0)} for k in KINDS}
        self.raw = {k: {"count": 0, "operand_bytes": 0} for k in KINDS}
        self.trip_counts: list = []
        self.replicated = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.allocations = 0  # storages tracked, each one allocation
        self._in_dtensor = False
        self._storages: dict = {}

    # memory
    def track(self, tensors) -> None:
        """Add the storages of `tensors` not yet live to the live bytes."""
        for t in tensors:
            if isinstance(t, self._fake) or not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._storages:
                continue
            n = s.nbytes()
            self._storages[key] = n
            self.live += n
            self.allocations += 1
            weakref.finalize(s, self._drop, key)
        self.peak = max(self.peak, self.live)

    def alias(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """dst is src (a functional collective's wait or wrap; on meta a new tensor):
        its bytes move to dst's storage, which holds them from now on."""
        self.track([src])
        s, d = src.untyped_storage(), dst.untyped_storage()
        if s._cdata == d._cdata or d._cdata in self._storages:
            return
        self._storages[d._cdata] = self._storages[s._cdata]
        self._storages[s._cdata] = 0
        weakref.finalize(d, self._drop, d._cdata)

    def _drop(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            if self._in_dtensor:
                return NotImplemented  # DTensor runs it; its local ops come back here
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in ins + outs):
            return out  # DTensor's shape propagation, not a local op
        if func.overloadpacket.__name__ in _NOT_COLLECTIVES:
            self.alias(ins[0], outs[0])
            return out
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size() for t in ins)
            c = self.collectives[kind]
            c["count"] += self.scale
            c["bytes"] += nbytes * self.scale
            self.raw[kind]["count"] += 1
            self.raw[kind]["operand_bytes"] += nbytes
        self.track(outs)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """func over DTensors, as DTensor runs it.  Where DTensor cannot (it raises:
        what a failed try counted is taken back), the DTensor inputs are made whole
        on one mesh axis after another, the last first, until it can; where it has
        no strategy at all, the op runs on the whole inputs' local tensors and its
        outputs are whole.  The all-gathers and all-reduces that costs are
        counted (those of a failed try are not), and the op is recorded in
        `replicated`.  An op that cannot run on whole inputs either raises."""
        from torch.utils._pytree import tree_map

        self._in_dtensor = True
        try:
            with self:
                snap = self._snapshot()
                try:
                    return func(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 — any of DTensor's own failures
                    self._restore(snap)
                    # its type and message alone: the exception's tracebacks (and its
                    # context's) hold this frame, so keeping it would make a
                    # reference cycle that keeps the op's tensors alive
                    first = (type(e), str(e))
                mesh = next(a for a in _flat(args, kwargs)
                            if isinstance(a, self._dtensor)).device_mesh
                tries = []
                for upto in range(mesh.ndim - 1, -1, -1):
                    def whole(a, upto=upto):
                        if not isinstance(a, self._dtensor):
                            return a
                        return self._moved(a, [self._replicate() if i >= upto else p
                                               for i, p in enumerate(a.placements)])
                    snap = self._snapshot()
                    try:
                        out = func(*tree_map(whole, args), **tree_map(whole, kwargs))
                    except Exception as e:  # noqa: BLE001
                        self._restore(snap)
                        tries.append(f"whole from mesh axis {upto}: {type(e).__name__}: "
                                     f"{str(e)[:300]}")
                        continue
                    self.replicated[str(func)] += 1
                    return out
                try:
                    out = self._run_whole(func, args, kwargs, mesh)
                except Exception as e:  # noqa: BLE001
                    tries.append(f"on whole local tensors: {type(e).__name__}: {str(e)[:300]}")
                    raise RuntimeError(f"{first[0].__name__}: {first[1]} (then "
                                       + "; ".join(tries) + ")") from None
                self.replicated[str(func)] += 1
                return out
        finally:
            self._in_dtensor = False

    def _moved(self, a, placements):
        """DTensor a laid out by `placements`, moved below autograd as DTensor's own
        dispatch moves its inputs (`DTensor.redistribute` is an autograd function,
        not for use inside an op's dispatch)."""
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        from torch.distributed.tensor._redistribute import redistribute_local_tensor

        if list(placements) == list(a.placements):
            return a
        spec = DTensorSpec(a.device_mesh, tuple(placements), tensor_meta=a._spec.tensor_meta)
        if a.numel() == 0:  # nothing to move (an op's empty buffer output, say)
            local = torch.empty(a.shape, dtype=a.dtype, device=a._local_tensor.device)
        else:
            local = redistribute_local_tensor(a._local_tensor, a._spec, spec)
        return self._dtensor(local, spec, requires_grad=False)

    def _run_whole(self, func, args, kwargs, mesh):
        """func on the local tensors of its inputs made whole; its outputs whole."""
        from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
        from torch.utils._pytree import tree_map

        whole = [self._replicate()] * mesh.ndim

        def local(a):
            if not isinstance(a, self._dtensor):
                return a
            return self._moved(a, whole)._local_tensor

        def wrap(t):
            if isinstance(t, torch.Tensor) and not isinstance(t, self._dtensor):
                meta = TensorMeta(t.shape, t.stride(), t.dtype)
                return self._dtensor(t, DTensorSpec(mesh, tuple(whole), tensor_meta=meta),
                                     requires_grad=False)
            return t
        return tree_map(wrap, func(*tree_map(local, args), **tree_map(local, kwargs)))

    def _snapshot(self):
        return (copy.deepcopy(self.collectives), copy.deepcopy(self.raw), self.peak)

    def _restore(self, snap) -> None:
        self.collectives, self.raw, self.peak = snap

    # the accounting hooks
    def kernel_call(self, name: str, impl, args, kw):
        """The SC matmul over DTensors as one op with a matmul's strategies."""
        if name != "sc_matmul":
            raise ValueError(f"no sharding strategy for kernel {name!r}")
        x, w = args
        if isinstance(x, self._dtensor) or isinstance(w, self._dtensor):
            return torch.ops.repro_torch_spmd.sc_matmul(x, w, kw["n_planes"])
        return impl(*args, **kw)

    @contextlib.contextmanager
    def repeated(self, n):
        """Count every collective inside n times more."""
        prev = self.scale
        self.scale = prev * Fraction(n)
        self.trip_counts.append(_number(Fraction(n)))
        try:
            yield
        finally:
            self.scale = prev

    def result(self) -> dict:
        """{collectives (trip-count-scaled), collective_bytes_total, collectives_raw
        (each body once), while_trip_counts}."""
        coll = {k: {"count": _number(v["count"]), "bytes": _number(v["bytes"])}
                for k, v in self.collectives.items()}
        return {"collectives": coll,
                "collective_bytes_total": sum(v["bytes"] for v in coll.values()),
                "collectives_raw": {k: dict(v) for k, v in self.raw.items()},
                "while_trip_counts": list(self.trip_counts),
                "replicated_ops": dict(sorted(self.replicated.items()))}


class _Layout(TorchFunctionMode):
    """The census's layout of the port's step, beside DTensor's own choices: the
    reference's hint sites (`constrain`) and the rules of the module docstring.

    As a torch function mode over the step it takes a product of equal-rank
    operands (`_matmul_sharding`), decode attention's softmax, a zero pad
    and a parameter in `gathered` while its module runs; `lay_out` hooks the
    module's linears, norms and gradients; `take` takes the compound ops the
    models mark.
    """

    def __init__(self, dmesh, mesh):
        super().__init__()
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard

        self.dmesh, self.mesh = dmesh, mesh
        self._dtensor, self._partial, self._replicate = DTensor, Partial, Replicate
        self._shard, self._strided = Shard, _StridedShard
        self.gathered: dict[int, int] = {}  # id of a parameter -> its module's id
        self._running: dict[int, int] = defaultdict(int)  # id of a module -> its depth
        from repro_torch.models.layers import (
            decode_attention, decode_attention_quant, flash_attention)
        from repro_torch.models.mamba2 import causal_conv, ssd_forward
        from repro_torch.models.transformer import chunked_cross_entropy

        self._compounds = {flash_attention: self._flash, chunked_cross_entropy: self._cross_entropy,
                           ssd_forward: self._ssd, causal_conv: self._causal_conv,
                           decode_attention: self._decode_attention,
                           decode_attention_quant: self._decode_attention}
        self._in_decode_attention = 0
        self._daxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    # -- layouts --------------------------------------------------------------------------
    def constrain(self, x, hint_mesh, daxes, spec):
        """x laid out by the reference's spec, or where it imposes none, settled to
        its batch over the data axes and whole on the others
        (`hints.batch_only_spec`), so that no partial sum crosses a block."""
        if not isinstance(x, self._dtensor):
            return x
        if spec is None:
            spec = hints.batch_only_spec(tuple(x.shape), self.mesh, daxes) or PartitionSpec()
        want = to_placements(spec, self.mesh)
        return x if tuple(x.placements) == tuple(want) else x.redistribute(self.dmesh, want)

    def reduced(self, x):
        """x with each partial placement reduced."""
        if not isinstance(x, self._dtensor):
            return x
        want = [self._replicate() if isinstance(p, self._partial) else p for p in x.placements]
        return x if want == list(x.placements) else x.redistribute(self.dmesh, want)

    def whole(self, x):
        """x on every device."""
        if not isinstance(x, self._dtensor):
            return x
        want = [self._replicate() for _ in x.placements]
        return x if want == list(x.placements) else x.redistribute(self.dmesh, want)

    def batch(self, x):
        """x laid out by its batch over the data axes alone, whole on the others.
        Always a node, so that the gradient comes back laid out so too."""
        if not isinstance(x, self._dtensor):
            return x
        spec = hints.batch_only_spec(tuple(x.shape), self.mesh, self._daxes) or PartitionSpec()
        return x.redistribute(self.dmesh, to_placements(spec, self.mesh))

    def rows(self, x):
        """x whole along every dim but the first and the last: the rows of a product
        over them (DTensor flattens the leading dims, and a split second dim would
        come out interleaved).  Always a node, so that the gradient comes back
        laid out so too."""
        if not isinstance(x, self._dtensor):
            return x
        last = x.ndim - 1
        want = [self._replicate() if (isinstance(p, self._shard) and 0 < p.dim < last)
                or isinstance(p, self._strided) else p for p in x.placements]
        return x.redistribute(self.dmesh, want)

    # -- the module's hooks ---------------------------------------------------------------
    def lay_out(self, module, train: bool) -> None:
        """Hook `module`: each linear takes its rows laid out by `rows` and gives
        them so, its bias gathered whole and added after; each norm's gain and
        bias are gathered where the norm takes them; under `train`, each
        gradient's partial sums are reduced where autograd makes it, once (data
        parallelism's all-reduce)."""
        from repro_torch.models.layers import RMSNorm
        from repro_torch.models.nn import LayerNorm, Linear
        from repro_torch.models.rglru import RGLRU

        for m in module.modules():
            if isinstance(m, Linear):
                m.register_forward_pre_hook(self._linear_in, with_kwargs=True)
                m.register_forward_hook(self._linear_out)
            elif isinstance(m, (RMSNorm, LayerNorm)):
                self._gather_at_use(m, m.parameters(recurse=False))
            elif isinstance(m, RGLRU):
                self._gather_at_use(m, [m.lam])
        if train:
            for p in module.parameters():
                p.register_hook(self.reduced)

    def _gather_at_use(self, m, params) -> None:
        for p in params:
            self.gathered[id(p)] = id(m)
        m.register_forward_pre_hook(self._enter)
        m.register_forward_hook(self._leave)

    def _enter(self, m, args):
        self._running[id(m)] += 1

    def _leave(self, m, args, out):
        self._running[id(m)] -= 1

    def _linear_in(self, m, args, kwargs):
        if m.b is not None:  # added by _linear_out, after the rows are laid out
            m.__dict__["b"] = None
        return (self.rows(args[0]), *args[1:]), kwargs

    def _linear_out(self, m, args, y):
        y = self.rows(y)
        b = m._parameters.get("b")
        if b is not None:
            del m.__dict__["b"]
            y = y + self.whole(b)
        return y

    # -- the torch function rules ---------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._any_dtensor(args) and not self._any_dtensor(kwargs.values()):
            return func(*args, **kwargs)
        if any(id(a) in self.gathered for a in args) and getattr(func, "__name__", "") != "__get__":
            args = tuple(self._gathered(a) for a in args)
        if func in _PRODUCTS:
            a, b = args[0], args[1]
            if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and (
                    a.ndim == b.ndim >= 3):
                return torch.ops.repro_torch_spmd.batched_matmul(a, b)
        elif func in _SOFTMAXES and self._in_decode_attention:
            return _softmax(*args, **kwargs)
        elif func in _PADS:
            return _zero_pad(*args, **kwargs)
        return func(*args, **kwargs)

    def _any_dtensor(self, items) -> bool:
        """Whether a DTensor is among items or in a list or tuple among them."""
        return any(isinstance(a, self._dtensor) or (
            isinstance(a, (list, tuple)) and any(isinstance(t, self._dtensor) for t in a))
            for a in items)

    # -- the port's compound ops (`core.overrides.overridable`) ----------------------------
    def take(self, op, body, args, kwargs):
        """The census's way with a marked op (`core.overrides.taking`)."""
        return self._compounds[op](body, *args, **kwargs)

    def _flash(self, body, q, k, v, **kw):
        """Flash attention on q, k and v with their partial sums reduced, once, before
        its loops slice them block by block."""
        return body(self.reduced(q), self.reduced(k), self.reduced(v), **kw)

    def _decode_attention(self, body, *args, **kw):
        """Decode attention with its softmax over the cache taken as max, exp and sum:
        over a cache split along its sequence the max and the sum are partial
        reductions, as GSPMD partitions them, where DTensor's own softmax would
        gather the sequence first."""
        self._in_decode_attention += 1
        try:
            return body(*args, **kw)
        finally:
            self._in_decode_attention -= 1

    def _cross_entropy(self, body, h, w_out, labels, **kw):
        """The chunked cross entropy on rows laid out by the batch alone and the LM head
        whole: each device's logits are its rows' over the whole vocabulary."""
        return body(self.batch(h), self.whole(w_out), labels, **kw)

    def _ssd(self, body, x, dt, A, B, C, **kw):
        """The SSD on inputs laid out by the batch alone (its einsums flatten the batch
        with the heads, which DTensor cannot keep split) and A whole; its output so."""
        x, dt, B, C = (self.batch(t) for t in (x, dt, B, C))
        y, state = body(x, dt, self.whole(A), B, C, **kw)
        return self.batch(y), state

    def _causal_conv(self, body, x, w, b):
        """The depthwise causal conv with its (small) taps and bias gathered whole."""
        return body(x, self.whole(w), self.whole(b))

    def _gathered(self, a):
        """a whole where it is a parameter in `gathered` and its module runs."""
        if self._running.get(self.gathered.get(id(a)), 0):
            return self.whole(a)
        return a


_PRODUCTS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
_SOFTMAXES = (torch.softmax, torch.Tensor.softmax, torch.nn.functional.softmax)
_PADS = (torch.nn.functional.pad, torch._C._nn.pad)


def _softmax(x, dim, *args, **kwargs):
    """softmax as max, exp and sum (`_Layout._decode_attention`)."""
    if args or kwargs.get("dtype") is not None:
        raise NotImplementedError("the census's softmax takes no dtype")
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _zero_pad(x, pad, mode="constant", value=None):
    """A zero pad as zero blocks concatenated on, laid out as x is (DTensor's pad of
    a tensor split over two mesh axes loses its layout on some torch versions)."""
    if mode != "constant" or value not in (None, 0, 0.0):
        raise NotImplementedError("the census pads with zeros only")
    for i in range(len(pad) // 2):
        dim = x.ndim - 1 - i
        lo, hi = pad[2 * i], pad[2 * i + 1]

        def zeros(n, dim=dim):
            return x.new_zeros(x.shape[:dim] + (n,) + x.shape[dim + 1:])
        parts = ([zeros(lo)] if lo else []) + [x] + ([zeros(hi)] if hi else [])
        x = torch.cat(parts, dim=dim) if len(parts) > 1 else x
    return x


@contextlib.contextmanager
def _backward_under(mode):
    """`mode` (a torch function mode) in force in the backward passes run inside the
    block too.  A torch function mode is not on the stack while it handles a call,
    and `torch.autograd.grad` is one: the engine would run the backward (the
    flash backward's products, every recompute) without it.  So the engine's
    entry point enters the mode again around the engine's run."""
    import torch.autograd as autograd

    run = getattr(autograd, "_engine_run_backward", None)
    if run is None:
        raise RuntimeError("this torch has no torch.autograd._engine_run_backward to enter "
                           "the census's layout around")

    def run_under(*args, **kwargs):
        with mode:
            return run(*args, **kwargs)
    autograd._engine_run_backward = run_under
    try:
        yield
    finally:
        autograd._engine_run_backward = run


def census(cfg, kind: str, batch: dict, state, mesh, policy_name: str = "fsdp_tp", *,
           microbatch: int | None = None, policy=None, s_max: int | None = None) -> dict:
    """Run the cell's step once over DTensors on a fake world of `mesh`'s size and
    return one device's collectives and memory.

    Keys: those of `Census.result`, and "memory": argument, output, alias,
    temp and peak bytes (rank 0's local storages; the peak counts the
    arguments, as XLA's does; alias is what the reference donates: the
    parameters and the AdamW state in train, the decode state in decode; temp
    = peak - arguments - outputs + alias).  The ops run on whole inputs are
    under "replicated_ops"; the storages the step allocated, under
    "allocations".
    """
    if accounting._counter is not None:
        raise RuntimeError("an op count is running: the census runs as a pass of its own")
    gc_was = gc.isenabled()
    with fake_world(mesh) as dmesh, census_strategies():
        from torch.distributed.tensor.experimental import implicit_replication

        cell = partitioned_cell(cfg, kind, batch, state, mesh, dmesh, policy_name,
                                microbatch=microbatch, policy=policy, s_max=s_max)
        hint_mode = "fsdp2d" if policy_name == "fsdp2d" else "off"
        layout = _Layout(dmesh, mesh)
        layout.lay_out(cell.args[0], train=kind == "train")
        mode = Census()
        args = _local_tensors(list(cell.args))
        mode.track(args)
        arg_bytes, arg_storages = mode.live, mode.allocations
        donated = storage_bytes(_local_tensors(list(cell.donated)))
        gc.disable()
        try:
            accounting.set_counter(mode)
            with (implicit_replication(), hints.census_layout(layout),
                  hints.activation_sharding(mesh, mode=hint_mode), _backward_under(layout),
                  overrides.taking(layout.take), layout, mode):
                out = cell.fn()
            out_bytes = storage_bytes(_local_tensors(out))
        finally:
            accounting.set_counter(None)
            if gc_was:
                gc.enable()
        res = mode.result()
        res["allocations"] = mode.allocations - arg_storages
        res["memory"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": donated,
            "temp_size_in_bytes": mode.peak - arg_bytes - out_bytes + donated,
            "peak_memory_in_bytes": mode.peak,
        }
        del out, cell, args
    return res

