"""Seeded violation: a model forward that accepts scope= and drops it."""

from repro_torch.core.scope import scope as _scope


def forward(params, x, *, scope="toy"):  # SEEDED: scope accepted, never opened
    return x @ params["w"]


def good_forward(params, x, *, scope="toy"):  # control: opens the range
    with _scope(scope):
        return x @ params["w"]


def delegating_step(params, x, *, scope="toy"):  # control: forwards scope=
    return good_forward(params, x, scope=scope)
