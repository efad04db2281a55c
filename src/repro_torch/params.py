"""Weight bridge: the JAX package's PointNet2 parameter tree -> this package's modules.

The tree is what the reference's `init_params` returns, with every leaf
turned into a numpy array (`jax.tree.map(np.asarray, params)`): nested
dicts and lists `sa[i]`, then `global` / `head` (cls) or `fp[i]` / `head`
(seg) -> `layers[j]` -> `lin{w, b}` and `ln{g, b}`.  The reference stores w as (d_in, d_out) and
computes y = x @ w; `models.nn.Linear` keeps that layout, so weights are
copied as they are, and every shape is checked against the config.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.nn import MLP
from repro_torch.models.pointnet2 import PointNet2Config, PointNet2Params


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
