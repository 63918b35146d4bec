"""Weight bridge: the JAX package's parameters -> the port's.

The input is the nested dict of numpy arrays that
``jax.tree.map(np.asarray, repro.models.Model(cfg).init(key))`` gives. Keys,
shapes and einsum layouts stay as they are (``wq (n, d, H, hd)``,
``wo (n, H, hd, d)``); only the storage dtype follows the port's rule
(``models.modules.storage_dtype``), which changes no value the model
computes with. :func:`expert_slice` cuts one model rank's routed experts
out of whole parameters, for the expert-parallel MoE.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.modules import storage_dtype, tree_leaves, tree_map_with_path


def params_from_numpy(tree: dict, cfg, device: str | torch.device, *, train: bool = False) -> dict:
    """-> the port's params tree on ``device``, every leaf f32 with ``train``
    (``storage_dtype``). Raises unless ``tree`` has exactly the keys and
    shapes of ``Model(cfg).spec()``."""
    want = {p: s.shape for p, s in tree_leaves(Model(cfg, device="meta").spec())}
    got = {p: tuple(np.shape(a)) for p, a in tree_leaves(tree)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"params tree does not match {cfg.name}'s spec: {diff[:8]}")

    def convert(path, a):
        a = np.array(a, dtype=np.float32)  # a writable copy: JAX hands out read-only buffers
        return torch.from_numpy(a).to(device=device, dtype=storage_dtype(path, a.ndim, train=train))

    return tree_map_with_path(convert, tree)


def expert_slice(params: dict, spec: dict, m: int, n_model: int) -> dict:
    """Model rank ``m`` of ``n_model``'s parameters for the expert-parallel
    MoE (``models/moe_shard_map.py``): each leaf of ``spec`` (the tree's
    ``ArraySpec``s, ``Model(cfg).spec()`` or a layer's ``moe_spec(cfg)``)
    whose first axis past a stacked ``layers`` axis is ``expert`` (the routed
    experts' ``wi``, ``wg``, ``wo``) cut to its m-th of ``n_model`` equal
    slices, a copy; every other leaf, the router among them, is the same
    tensor."""
    specs = dict(tree_leaves(spec))

    def cut(path, a):
        logical = specs[path].logical
        d = 1 if logical[0] == "layers" else 0
        if logical[d] != "expert":
            return a
        n = a.shape[d] // n_model
        if n * n_model != a.shape[d]:
            raise ValueError(f"{'/'.join(path)}: {a.shape[d]} experts do not split over {n_model} model ranks")
        return a.narrow(d, m * n, n).clone()

    return tree_map_with_path(cut, params)
