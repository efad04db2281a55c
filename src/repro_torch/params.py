"""Weight bridge: the JAX package's parameter trees <-> this package's modules.

PointNet2 (`from_jax_params`, `to_jax_params`) and the dense LMs
(`lm_from_jax_params`, `lm_to_jax_params`, and their train state in the
reference's layout, `lm_state_to_tree`, `lm_state_from_tree`, at the end
of this file).

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
from repro_torch.models.transformer import DenseLM, group_geometry


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


# -- the dense LMs -------------------------------------------------------------------
#
# The reference's LM tree is {"embed" (V, D), "final_norm" {g[, b]}, "lm_head"
# (D, V) unless tied, "blocks": [one tree a slot]}, each slot's tree the
# block's ({"ln1", "attn" {"wq", "wk", "wv", "wo"} {w[, b]}, "ln2", "mlp"
# {"wi"[, "wg"], "wo"}}) with every leaf stacked over the groups, (n_groups,
# ...) (`transformer.py:120-125` of the JAX package).  Layer i of the port's
# `DenseLM.blocks` is group i // g, slot i % g.  bf16 leaves arrive as numpy
# arrays of ml_dtypes' bfloat16, the dtype `np.asarray` gives a JAX bf16
# array; they are carried over bit for bit.


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


def _flat_tree(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_tree(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def _fill(params: dict, leaves: dict, where: str, group: int | None = None) -> None:
    if set(params) != set(leaves):
        raise ValueError(f"{where}: the tree holds {sorted(leaves)}, the config "
                         f"{sorted(params)}")
    for name, p in params.items():
        t = _leaf_to_torch(leaves[name])
        if group is not None:
            t = t[group]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{where}.{name}: {t.dtype} {tuple(t.shape)} does not match "
                             f"{p.dtype} {tuple(p.shape)}")
        p.copy_(t)


def lm_from_jax_params(tree, cfg, device=None) -> DenseLM:
    """A DenseLM for `cfg` holding the reference's LM parameter tree (numpy leaves).

    Every leaf must have the config's shape and dtype.  device: where the
    parameters end up ("cuda" by default, like every entry point).
    """
    dev = resolve_device(device)
    module = DenseLM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    n_groups, g = group_geometry(cfg)
    if len(tree["blocks"]) != g:
        raise ValueError(f"tree has {len(tree['blocks'])} slots, config has {g}")
    with torch.no_grad():
        _fill({n: p for n, p in module.named_parameters() if not n.startswith("blocks.")},
              _flat_tree({k: v for k, v in tree.items() if k != "blocks"}), "top")
        for i, block in enumerate(module.blocks):
            slot, grp = i % g, i // g
            leaves = _flat_tree(tree["blocks"][slot])
            for name, leaf in leaves.items():
                if np.shape(leaf)[0] != n_groups:
                    raise ValueError(f"blocks[{slot}].{name}: {np.shape(leaf)[0]} groups, "
                                     f"config has {n_groups}")
            _fill(dict(block.named_parameters()), leaves, f"blocks[{slot}] group {grp}", grp)
    return module.to(dev)


def lm_to_jax_params(module: DenseLM) -> dict:
    """The reverse of `lm_from_jax_params`: the reference's tree, numpy leaves, each
    slot's leaves stacked over the groups."""
    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_numpy(v) for v in tree]
        return _leaf_to_numpy(tree)

    return to_numpy(_lm_tree(named_jax_params(module), *group_geometry(module.cfg)))


# -- the LM train state in the reference's layout ------------------------------------
#
# A checkpoint of {"params": DenseLM, "opt": AdamWState} through
# `tree_leaves` would name layer i "blocks.i....": not the reference's tree,
# whose blocks[slot] leaves are stacked over the groups.  The two functions
# below convert the whole train state, the moments and the float32 master
# copy stacked as the parameters are, so a checkpoint written by the port
# is the one the reference writes from the same state.


def _lm_tree(named: dict, n_groups: int, g: int, device=None) -> dict:
    """{reference dotted name: tensor} of a DenseLM -> the reference's nested tree,
    each slot's leaves stacked over the groups (new tensors) on `device`
    (None: where the tensors lie).  Each tensor moves before it is stacked,
    so a stack on the host takes no memory on the card."""

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach() if device is None else t.detach().to(device)

    tree = _nest((_parts(n), leaf(t)) for n, t in named.items() if not n.startswith("blocks."))
    tree["blocks"] = []
    for slot in range(g):
        prefix = f"blocks.{slot}."
        names = [n[len(prefix):] for n in named if n.startswith(prefix)]
        tree["blocks"].append(_nest(
            (_parts(n), torch.stack([leaf(named[f"blocks.{grp * g + slot}.{n}"])
                                     for grp in range(n_groups)]))
            for n in names))
    return tree


def _lm_leaf(tree: dict, name: str, g: int) -> torch.Tensor:
    """The leaf of `tree` (the reference's layout) that holds port parameter `name`."""
    parts = _parts(name)
    group = None
    if parts[0] == "blocks":
        layer = parts[1]
        node, parts, group = tree["blocks"][layer % g], parts[2:], layer // g
    else:
        node = tree
    for part in parts:
        node = node[part]
    return node if group is None else node[group]


def lm_state_to_tree(state: dict, device=None) -> dict:
    """{"params": DenseLM, "opt": AdamWState} -> the reference's train state tree.

    {"params": the LM tree of `lm_to_jax_params` as tensors, "opt":
    AdamWState(step, mu, nu, master)} with mu, nu and master (None when
    absent) stacked like the parameters.  The leaves are new tensors on
    `device` (None: the state's; "cpu" stages a card's state through the
    host; "meta" gives the structure alone, a restore's template);
    `checkpoint.save_checkpoint` of this tree writes the reference's bytes.
    """
    module, opt = state["params"], state["opt"]
    n_groups, g = group_geometry(module.cfg)

    def tree(named):
        return None if named is None else _lm_tree(named, n_groups, g, device)

    step = opt.step if device is None else opt.step.to(device)
    return {"params": tree(named_jax_params(module)),
            "opt": type(opt)(step, tree(opt.mu), tree(opt.nu), tree(opt.master))}


def lm_state_from_tree(state: dict, tree: dict) -> dict:
    """Copy `tree` (the reference's layout, as `lm_state_to_tree` gives it and a
    checkpoint restores it) into `state`'s own tensors in place; returns `state`.

    Every leaf must have its target's shape and dtype, and the master copy
    must be present in both or in neither.
    """
    module, opt = state["params"], state["opt"]
    _, g = group_geometry(module.cfg)
    src = tree["opt"]
    if (opt.master is None) != (src.master is None):
        raise ValueError("the tree and the state disagree on a float32 master copy")
    pairs = [(opt.step, src.step, "opt.step")]
    pairs += [(p, _lm_leaf(tree["params"], n, g), n)
              for n, p in named_jax_params(module).items()]
    for field in ("mu", "nu", "master"):
        named = getattr(opt, field)
        if named is not None:
            pairs += [(t, _lm_leaf(getattr(src, field), n, g), f"opt.{field}.{n}")
                      for n, t in named.items()]
    with torch.no_grad():
        for dst, value, where in pairs:
            if tuple(value.shape) != tuple(dst.shape) or value.dtype != dst.dtype:
                raise ValueError(f"{where}: {value.dtype} {tuple(value.shape)} does not match "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(value)
    return state
