"""AdamW with global-norm clipping (a copy of ``repro.optim.adamw``).

The optimizer state (m, v) mirrors the parameter tree. All arithmetic is f32
whatever the parameter or moment dtype, with bias correction at ``step`` in
f32. Where the JAX package returns new trees, the port updates parameters,
m and v in place under ``torch.no_grad()``: at full qwen3-4b, parameters,
gradients and the two moments take 70.6 GB of the card's 80, and a
functional copy of the parameters would not fit. Metrics stay on the device:
no host sync inside the update.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.scope import scope
from repro_torch.models.modules import tree_leaves, tree_map_with_path


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves(tree)]


def adamw_init(params, *, moment_dtype: torch.dtype = torch.float32) -> dict:
    """``moment_dtype=torch.bfloat16`` halves the optimizer's memory; the
    update math stays f32. The step lives on the parameters' device."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device),
        "m": tree_map_with_path(zeros, params),
        "v": tree_map_with_path(zeros, params),
    }


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all leaves together, in f32 (a 0-d tensor): the norm of
    the leaves' norms, so no leaf-sized temporary is made."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32) for x in _leaves(tree)])
    )


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, *, lr: float | torch.Tensor, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, in place: the leaves of ``params`` and the state's m
    and v are overwritten, the step advanced, and each gradient leaf used as
    scratch (its values are lost). -> (params, opt_state, {"grad_norm",
    "clip_scale"}), the same objects, metrics as 0-d device tensors. Runs
    under the JAX package's ``optimizer`` scope."""
    with scope("optimizer"):
        return _adamw_update(grads, opt_state, params, lr, cfg)


def _adamw_update(grads, opt_state: dict, params, lr, cfg: AdamWConfig):
    flat_p, flat_g = _leaves(params), _leaves(grads)
    flat_m, flat_v = _leaves(opt_state["m"]), _leaves(opt_state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the optimizer state must have one tree structure")
    opt_state["step"] += 1
    step = opt_state["step"].to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), step)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v, strict=True):
        g32 = g if g.dtype == torch.float32 else g.float()
        g32.mul_(scale)
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(cfg.b1).add_(g32, alpha=1.0 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g32, g32, value=1.0 - cfg.b2)
        # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p, built in the gradient's memory
        # (the division by bc1 comes last here: no temporary of the leaf's size)
        torch.div(v32, bc2, out=g32).sqrt_().add_(cfg.eps)
        torch.div(m32, g32, out=g32).div_(bc1)
        p32 = p if p.dtype == torch.float32 else p.float()
        g32.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p32.sub_(g32)
        for low, full in ((p, p32), (m, m32), (v, v32)):
            if low is not full:
                low.copy_(full)
    return params, opt_state, {"grad_norm": gnorm, "clip_scale": scale}
