"""Step-function builders shared by the trainer, the server and the tests
(the counterpart of ``repro.launch.steps``), under its scopes
(``train_step``, ``fwd_bwd``, ``serve_step``, ``eval_step``)."""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.core.scope import scope
from repro_torch.models import Model
from repro_torch.models.modules import tree_leaves, tree_map_with_path
from repro_torch.optim import AdamWConfig, adamw_update


def _zeros_f32(tree):
    return tree_map_with_path(lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def make_train_step(
    model: Model,
    lr_fn: Callable,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    grad_accum: int = 1,
):
    """-> train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    As the JAX package's: ``grad_accum > 1`` splits the batch's leading axis
    into that many microbatches and sums their gradients in f32 before
    dividing; the loss is their mean, the aux terms the last microbatch's;
    the learning rate is taken at the optimizer's step before the update.
    Parameters and optimizer state are updated in place and returned; the
    f32 gradients live in one buffer the step keeps between calls (the
    first call makes it, or ``train_step.prime(params)``, which returns it,
    before that). Metrics
    are 0-d device tensors: {"loss", "lr", "ce", "z_loss", "lb_loss",
    "grad_norm", "clip_scale"}.
    """
    grads = None

    def train_step(params, opt_state, batch):
        with scope("train_step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        nonlocal grads
        if grads is None:
            grads = _zeros_f32(params)
        else:
            torch._foreach_zero_([g for _, g in tree_leaves(grads)])
        leaves = model.grad_leaves(params, grads)
        B = next(iter(batch.values())).shape[0]
        if B % grad_accum:
            raise ValueError(f"batch of {B} does not split into {grad_accum} microbatches")
        loss = None
        with scope("fwd_bwd"):
            for i in range(grad_accum):
                micro = {k: v[i * B // grad_accum : (i + 1) * B // grad_accum] for k, v in batch.items()}
                mloss, aux = model.loss(leaves, micro)
                mloss.backward()
                loss = mloss.detach() if loss is None else loss + mloss.detach()
        if grad_accum > 1:
            torch._foreach_div_([g for _, g in tree_leaves(grads)], grad_accum)
            loss = loss / grad_accum
        lr = lr_fn(opt_state["step"])
        params, opt_state, om = adamw_update(grads, opt_state, params, lr=lr, cfg=opt_cfg)
        return params, opt_state, {"loss": loss, "lr": lr, **{k: v.detach() for k, v in aux.items()}, **om}

    def prime(params):
        nonlocal grads
        if grads is None:
            grads = _zeros_f32(params)
        return grads

    train_step.prime = prime
    return train_step


def make_eval_step(model: Model):
    """-> eval_step(params, batch) -> {"loss", "ce", "z_loss", "lb_loss"}."""

    @torch.no_grad()
    def eval_step(params, batch):
        with scope("eval_step"):
            loss, aux = model.loss(params, batch)
            return {"loss": loss, **aux}

    return eval_step


def make_serve_step(model: Model):
    """-> serve_step(params, batch, state, pos) -> (greedy next tokens (B,) int32, state)."""

    def serve_step(params, batch, state, pos):
        with scope("serve_step"):
            logits, new_state = model.decode_step(params, batch, state, pos)
            return torch.argmax(logits, dim=-1).to(torch.int32), new_state

    return serve_step
