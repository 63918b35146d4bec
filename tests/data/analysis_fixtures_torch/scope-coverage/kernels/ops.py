"""Seeded violations: a launched kernel with no public wrapper of its name,
and a kernel wrapper that opens no scope(...) range."""

from repro_torch.core.scope import kernel_launch, scope


def fused_rmsnorm(x):  # SEEDED: the wrapper of a launched kernel, no scope(...)
    return _rmsnorm_fwd(x)


def _rmsnorm_fwd(x):
    with kernel_launch("fused_rmsnorm", lambda: (0.0, 0.0)):
        return x


def _orphan_fwd(x):
    with kernel_launch("orphan_scan", lambda: (0.0, 0.0)):  # SEEDED: no wrapper named orphan_scan
        return x


def flash_attention(q):  # control: opens its range
    with scope("flash_attention"):
        return _flash_fwd(q)


def _flash_fwd(q):
    with kernel_launch("flash_attention", lambda: (0.0, 0.0)):
        return q


def flash_attention_bwd(q, do):  # control: a backward wrapper opens its forward's name
    with scope("flash_attention"):
        return _flash_bwd(q, do)


def _flash_bwd(q, do):
    with kernel_launch("flash_attention_bwd", lambda: (0.0, 0.0)):
        return q, do


def launch_counts():  # control: a public helper that launches nothing
    return {}
