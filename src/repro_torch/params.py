"""Weight bridge: the JAX package's parameters -> the port's.

The input is the nested dict of numpy arrays that
``jax.tree.map(np.asarray, repro.models.Model(cfg).init(key))`` gives. Keys,
shapes and einsum layouts stay as they are (``wq (n, d, H, hd)``,
``wo (n, H, hd, d)``); only the storage dtype follows the port's rule
(``models.modules.storage_dtype``), which changes no value the model
computes with.
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
