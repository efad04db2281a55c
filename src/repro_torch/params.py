"""Weight bridge: the JAX package's parameter trees <-> this package's modules.

PointNet2 (`from_jax_params`, `to_jax_params`) and the LMs of every family
(`lm_from_jax_params`, `lm_to_jax_params`,
and their train state in the reference's layout, `lm_state_to_tree`,
`lm_state_from_tree`, at the end of this file).

The tree is what the reference's `init_params` returns, with every leaf
turned into a numpy array (`jax.tree.map(np.asarray, params)`): nested
dicts and lists `sa[i]`, then `global` / `head` (cls) or `fp[i]` / `head`
(seg) -> `layers[j]` -> `lin{w, b}` and `ln{g, b}`.  The reference stores w as (d_in, d_out) and
computes y = x @ w; `models.nn.Linear` keeps that layout, so weights are
copied as they are, and every shape is checked against the config.

`to_jax_params` goes the other way, and the leaf walk below
(`tree_leaves`, `tree_unflatten`) puts a port tree's leaves in the order
`jax.tree_util.tree_flatten` gives the reference's tree, which is the
order of a checkpoint's records (`checkpoint/store.py`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.nn import MLP
from repro_torch.models.pointnet2 import PointNet2Config, PointNet2Params
from repro_torch.models.families import get_family_api, hybrid_geometry
from repro_torch.models.transformer import group_geometry


def _copy(param: torch.Tensor, value, where: str) -> None:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if arr.shape != tuple(param.shape):
        raise ValueError(f"{where}: shape {arr.shape} does not match {tuple(param.shape)}")
    param.copy_(torch.from_numpy(arr))


def _load_mlp(mlp: MLP, tree, where: str) -> None:
    layers = tree["layers"]
    if len(layers) != len(mlp.layers):
        raise ValueError(f"{where}: {len(layers)} layers, config has {len(mlp.layers)}")
    for j, (layer, leaf) in enumerate(zip(mlp.layers, layers)):
        at = f"{where}.layers[{j}]"
        _copy(layer.lin.w, leaf["lin"]["w"], f"{at}.lin.w")
        if ("b" in leaf["lin"]) != (layer.lin.b is not None):
            raise ValueError(f"{at}.lin: bias presence differs from the config")
        if layer.lin.b is not None:
            _copy(layer.lin.b, leaf["lin"]["b"], f"{at}.lin.b")
        if ("ln" in leaf) != (layer.ln is not None):
            raise ValueError(f"{at}: LayerNorm presence differs from the config")
        if layer.ln is not None:
            _copy(layer.ln.g, leaf["ln"]["g"], f"{at}.ln.g")
            _copy(layer.ln.b, leaf["ln"]["b"], f"{at}.ln.b")


def from_jax_params(tree, cfg: PointNet2Config, device=None) -> PointNet2Params:
    """Fill a PointNet2Params for `cfg` from the reference's parameter tree.

    device: where the parameters end up ("cuda" by default, like every entry
    point; pass "cpu" on a host without a card).
    """
    dev = resolve_device(device)
    params = PointNet2Params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    lists = {"sa": params.sa} if cfg.task == "cls" else {"sa": params.sa, "fp": params.fp}
    with torch.no_grad():
        for key, mlps in lists.items():
            if len(tree[key]) != len(mlps):
                raise ValueError(
                    f"tree has {len(tree[key])} {key} stages, config has {len(mlps)}"
                )
            for i, (mlp, sub) in enumerate(zip(mlps, tree[key])):
                _load_mlp(mlp, sub, f"{key}[{i}]")
        if cfg.task == "cls":
            _load_mlp(params.global_mlp, tree["global"], "global")
        _load_mlp(params.head, tree["head"], "head")
    return params.to(dev)


# -- the reference's tree layout ----------------------------------------------------
#
# The JAX package keeps parameters, optimizer moments and checkpoints as
# pytrees, and `jax.tree_util.tree_flatten` orders their leaves: dict keys
# sorted, lists and tuples in order, NamedTuple fields in order, None with
# no leaves.  The port holds the same values as a module (`PointNet2Params`)
# and as dicts keyed by dotted parameter names ("sa.0.layers.1.lin.w", the
# reference's `tree["sa"][0]["layers"][1]["lin"]["w"]`).  Every leaf gets
# its reference path, a tuple whose parts are dict keys (str) and list,
# tuple or field positions (int), and sorting the paths gives JAX's order.


def named_jax_params(module: torch.nn.Module) -> dict:
    """{reference dotted name: parameter} of a module, in the module's own order.

    The names are the module's own but for PointNet2Params' `global_mlp`,
    which the reference's tree calls "global".
    """
    return {("global" + n[len("global_mlp"):] if n.startswith("global_mlp.") else n): p
            for n, p in module.named_parameters()}


def _parts(name: str) -> tuple:
    return tuple(int(c) if c.isdigit() else c for c in name.split("."))


def tree_paths(tree, prefix: tuple = ()) -> list:
    """(reference path, leaf) of every leaf of a port tree, in the port's own order.

    A module contributes its parameters by reference name; a dict's keys
    are split at dots; lists, tuples and NamedTuples index their items;
    None has no leaves; anything else is a leaf.
    """
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        return [(prefix + _parts(n), p) for n, p in named_jax_params(tree).items()]
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in tree_paths(v, prefix + _parts(str(k)))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """The leaves of a port tree in `jax.tree_util.tree_flatten`'s order."""
    return [leaf for _, leaf in sorted(tree_paths(tree), key=lambda pl: pl[0])]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves`, given in `tree_leaves(like)`'s order.

    A module in `like` comes back as a deep copy whose parameters are the
    new leaves (their storage, device and dtype).
    """
    paths = sorted(p for p, _ in tree_paths(like))
    leaves = list(leaves)
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    return _rebuild(like, (), dict(zip(paths, leaves)))


def _rebuild(like, prefix: tuple, by_path: dict):
    if like is None:
        return None
    if isinstance(like, torch.nn.Module):
        module = copy.deepcopy(like)
        for n, p in named_jax_params(module).items():
            p.data = by_path[prefix + _parts(n)]
        return module
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, prefix + _parts(str(k)), by_path))
                          for k, v in like.items())
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, prefix + (i,), by_path) for i, v in enumerate(like)]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    return by_path[prefix]


def _nest(pairs) -> dict:
    """Nested dicts and lists from (path, value) pairs."""
    root: dict = {}
    for path, value in pairs:
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def to_jax_params(params: PointNet2Params) -> dict:
    """The reverse of `from_jax_params`: the reference's parameter tree, leaves as numpy arrays."""
    return _nest((_parts(n), p.detach().cpu().numpy().copy())
                 for n, p in named_jax_params(params).items())


# -- the LMs -------------------------------------------------------------------------
#
# The reference's LM trees (numpy leaves, as `jax.tree.map(np.asarray, params)`
# gives them):
#   dense / moe: {"embed" (V, D), "final_norm" {g[, b]}, "lm_head" (D, V) unless
#     tied, "blocks": [one tree a slot]}, each slot's tree the block's ({"ln1",
#     "attn" {"wq", "wk", "wv", "wo"} {w[, b]}, "ln2", "mlp" {"wi"[, "wg"], "wo"}},
#     moe's "mlp" {"router" {w}, "wi", "wg", "wo"}) with every leaf stacked over
#     the groups, (n_groups, ...) (`transformer.py:120-125` of the JAX package);
#   ssm: {"embed", "blocks" {"norm", "mixer"} stacked over the L layers (one
#     dict, not a list of slots), "final_norm"};
#   hybrid: {"embed", "blocks": [one tree a slot, stacked over the groups],
#     "rem": [one unstacked tree a remainder layer], "final_norm"};
#   encdec: {"embed", "enc_blocks" {"ln1", "attn", "ln2", "mlp"} stacked over
#     the encoder's layers and "dec_blocks" {"ln1", "self_attn", "ln_x",
#     "cross_attn", "ln2", "mlp"} over the decoder's (each one dict, as the
#     ssm's blocks), "enc_norm", "final_norm"};
#   vlm: the dense tree and "patch_proj" {w, b}.
# The port's layer i of `blocks` is group i // g, slot i % g (the ssm: g = 1);
# the hybrid's `rem` are its own modules; encdec's layer i of `enc_blocks` or
# `dec_blocks` is that stack's leaf i.  bf16 leaves arrive as numpy arrays
# of ml_dtypes' bfloat16, the dtype `np.asarray` gives a JAX bf16 array; they
# are carried over bit for bit.


def _leaf_to_torch(value) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype and bytes (bf16 by its bits)."""
    arr = np.array(value, order="C")  # a C-ordered copy; a 0-d leaf stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype and bytes; bf16 becomes ml_dtypes'
    bfloat16, which is imported only then."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _map_tree(tree, fn):
    """fn over every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _flat_tree(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of nested dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in _flat_tree(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def lm_layout(cfg) -> tuple[int, int, str]:
    """(n_groups, layers a group, family) of the reference's LM tree for `cfg`:
    the ssm's blocks are its L layers stacked, g = 1; encdec's two stacks are
    each one dict, g = 1, and count their own layers."""
    if cfg.family in ("ssm", "encdec"):
        return cfg.n_layers, 1, cfg.family
    if cfg.family == "hybrid":
        n_groups, g, _ = hybrid_geometry(cfg)
        return n_groups, g, "hybrid"
    return (*group_geometry(cfg), cfg.family)


# The stacks of layers in each family's tree: {port ModuleList: stacked as one
# dict (True) or as a list of one tree a slot (False)}.
_STACKS = {"ssm": {"blocks": True}, "encdec": {"enc_blocks": True, "dec_blocks": True}}


def _stacks(family: str) -> dict:
    return _STACKS.get(family, {"blocks": False})


def lm_from_jax_params(tree, cfg, device=None) -> torch.nn.Module:
    """The family's module (`get_family_api(cfg)["init"]`) holding the reference's LM
    parameter tree (numpy leaves).

    The tree must hold exactly the config's leaves, each of its shape and
    dtype.  device: where the parameters end up ("cuda" by default, like every
    entry point).
    """
    dev = resolve_device(device)
    module = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    layout = lm_layout(cfg)
    want = _flat_tree(_lm_tree(named_jax_params(module), *layout, device="meta"))
    torch_tree = _map_tree(tree, _leaf_to_torch)
    got = _flat_tree(torch_tree)
    if set(got) != set(want):
        raise ValueError(f"the tree holds {sorted(set(got) - set(want))} beyond the config's "
                         f"leaves and lacks {sorted(set(want) - set(got))}")
    for path, t in got.items():
        w = want[path]
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"{path}: {t.dtype} {tuple(t.shape)} does not match "
                             f"{w.dtype} {tuple(w.shape)}")
    with torch.no_grad():
        for name, p in named_jax_params(module).items():
            p.copy_(_lm_leaf(torch_tree, name, layout))
    return module.to(dev)


def lm_to_jax_params(module: torch.nn.Module) -> dict:
    """The reverse of `lm_from_jax_params`: the reference's tree, numpy leaves, the
    layers stacked as the reference stacks them."""
    return _map_tree(_lm_tree(named_jax_params(module), *lm_layout(module.cfg)), _leaf_to_numpy)


# -- the LM train state in the reference's layout ------------------------------------
#
# A checkpoint of {"params": module, "opt": AdamWState} through `tree_leaves`
# would name layer i "blocks.i....": not the reference's tree, whose layers
# are stacked.  The two functions below convert the whole train state, the
# moments and the float32 master copy stacked as the parameters are, so a
# checkpoint written by the port is the one the reference writes from the
# same state.


def _lm_tree(named: dict, n_groups: int, g: int, family: str = "dense",
             device=None) -> dict:
    """{reference dotted name: tensor} of an LM module -> the reference's nested tree
    (`lm_layout`), each slot's leaves stacked over the groups (new tensors) on
    `device` (None: where the tensors lie).  Each tensor moves before it is
    stacked, so a stack on the host takes no memory on the card."""

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach() if device is None else t.detach().to(device)

    stacks = _stacks(family)
    tree = _nest((_parts(n), leaf(t)) for n, t in named.items()
                 if n.split(".", 1)[0] not in stacks)
    for key, as_one in stacks.items():
        if as_one:  # one dict stacked over every layer of the stack
            layers = len({n.split(".")[1] for n in named if n.startswith(f"{key}.")})
            n_stack, slots = layers, 1
        else:
            n_stack, slots = n_groups, g
        tree[key] = []
        for slot in range(slots):
            prefix = f"{key}.{slot}."
            names = [n[len(prefix):] for n in named if n.startswith(prefix)]
            tree[key].append(_nest(
                (_parts(n), torch.stack([leaf(named[f"{key}.{grp * slots + slot}.{n}"])
                                         for grp in range(n_stack)]))
                for n in names))
        if as_one:
            tree[key] = tree[key][0]
    if family == "hybrid":
        tree.setdefault("rem", [])
    return tree


def lm_leaf_key(name: str, layout: tuple) -> tuple[tuple, int | None]:
    """Where port parameter `name` sits in the reference's tree (`lm_layout`): (the
    path of its leaf, the group it takes along the leaf's stacked first dim, or
    None where the leaf is not stacked)."""
    _, g, family = layout
    stacks = _stacks(family)
    parts = _parts(name)
    if parts[0] not in stacks:
        return parts, None
    layer = parts[1]
    if stacks[parts[0]]:
        return (parts[0], *parts[2:]), layer
    return (parts[0], layer % g, *parts[2:]), layer // g


def _lm_leaf(tree: dict, name: str, layout: tuple) -> torch.Tensor:
    """The leaf of `tree` (the reference's layout) that holds port parameter `name`."""
    path, group = lm_leaf_key(name, layout)
    node = tree
    for part in path:
        node = node[part]
    return node if group is None else node[group]


def lm_param_tree(module: torch.nn.Module, device=None) -> dict:
    """An LM module's parameters as the reference's tree (`lm_layout`): new tensors,
    the layers stacked, on `device` (None: the module's; "meta" gives the shapes
    and dtypes alone)."""
    return _lm_tree(named_jax_params(module), *lm_layout(module.cfg), device=device)


def lm_state_to_tree(state: dict, device=None) -> dict:
    """{"params": LM module, "opt": AdamWState} -> the reference's train state tree.

    {"params": the LM tree of `lm_to_jax_params` as tensors, "opt":
    AdamWState(step, mu, nu, master)} with mu, nu and master (None when
    absent) stacked like the parameters.  The leaves are new tensors on
    `device` (None: the state's; "cpu" stages a card's state through the
    host; "meta" gives the structure alone, a restore's template);
    `checkpoint.save_checkpoint` of this tree writes the reference's bytes.
    """
    module, opt = state["params"], state["opt"]
    layout = lm_layout(module.cfg)

    def tree(named):
        return None if named is None else _lm_tree(named, *layout, device=device)

    step = opt.step if device is None else opt.step.to(device)
    return {"params": lm_param_tree(module, device=device),
            "opt": type(opt)(step, tree(opt.mu), tree(opt.nu), tree(opt.master))}


def lm_state_from_tree(state: dict, tree: dict) -> dict:
    """Copy `tree` (the reference's layout, as `lm_state_to_tree` gives it and a
    checkpoint restores it) into `state`'s own tensors in place; returns `state`.

    Every leaf must have its target's shape and dtype, and the master copy
    must be present in both or in neither.
    """
    module, opt = state["params"], state["opt"]
    layout = lm_layout(module.cfg)
    src = tree["opt"]
    if (opt.master is None) != (src.master is None):
        raise ValueError("the tree and the state disagree on a float32 master copy")
    pairs = [(opt.step, src.step, "opt.step")]
    pairs += [(p, _lm_leaf(tree["params"], n, layout), n)
              for n, p in named_jax_params(module).items()]
    for field in ("mu", "nu", "master"):
        named = getattr(opt, field)
        if named is not None:
            pairs += [(t, _lm_leaf(getattr(src, field), n, layout), f"opt.{field}.{n}")
                      for n, t in named.items()]
    with torch.no_grad():
        for dst, value, where in pairs:
            if tuple(value.shape) != tuple(dst.shape) or value.dtype != dst.dtype:
                raise ValueError(f"{where}: {value.dtype} {tuple(value.shape)} does not match "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(value)
    return state
