"""Step-function builders shared by the server and the tests."""

from __future__ import annotations

import torch

from repro_torch.models import Model


def make_serve_step(model: Model):
    """-> serve_step(params, batch, state, pos) -> (greedy next tokens (B,) int32, state)."""

    def serve_step(params, batch, state, pos):
        logits, new_state = model.decode_step(params, batch, state, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state

    return serve_step
