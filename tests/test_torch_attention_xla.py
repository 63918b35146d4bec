"""The port's xla-path attention references (``_attend_full`` and
``_attend_chunked`` in ``repro_torch.models.attention``) against the JAX
package's (``repro.models.attention``) on the CPU, in f32 and bf16, with the
same inputs from numpy: the outputs and the gradients of ``(o . r).sum()``
in q, k and v. The cases cover GQA and MQA, a query offset (``_attend_full``
only, as in JAX), no window, a window whose keys fit every chunk, a window
with the (window + chunk)-key strip, and a length that is no multiple of the
chunk. ``_attend_chunked`` on f32 inputs is also held to the port's plain
``ref.attention_ref``, to f32 tolerance: the oracle ``chip_smoke.py`` holds
the flash kernels to at 32k tokens.

Tolerances: tests/test_kernels.py's, f32 2e-5 and bf16 2e-2, relative to
each value and absolute (for the gradients, scaled by the gradient's
largest entry: dk and dv sum over many query rows in another order)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# name -> (B, S, Hq, Hkv, D, window, chunk, q_offset): T = S, but for the
# offset case (8 queries after 16 earlier keys)
CASES = {
    "gqa": (2, 24, 4, 2, 8, None, 16, 0),
    "mqa_window": (1, 32, 4, 1, 16, 8, 16, 0),
    "window_strip": (1, 64, 4, 2, 8, 8, 16, 0),  # window + chunk = 24 < 64
    "window_no_strip": (1, 32, 2, 2, 8, 24, 16, 0),  # window + chunk >= T
    "ragged_chunks": (2, 40, 4, 2, 8, None, 16, 0),  # 40 = 2.5 chunks
    "q_offset": (1, 8, 4, 2, 8, None, 16, 16),
}
CHUNKED = [c for c, v in CASES.items() if v[-1] == 0]


def _inputs(case: str, dtype: str, seed: int = 0):
    B, S, Hq, Hkv, D, window, chunk, q_offset = CASES[case]
    rng = np.random.default_rng(seed)
    T = S + q_offset
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, S, Hq, D))]
    jcfg = dataclasses.replace(jax_config("qwen3-4b", smoke=True), chunk=chunk)
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), chunk=chunk)
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays[:3]] + [jnp.asarray(arrays[3])]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays[:3]] + [torch.from_numpy(arrays[3])]
    return jcfg, cfg, j, t, window, q_offset


def _fns(name: str, window, q_offset):
    if name == "full":
        return (lambda q, k, v, c: jattn._attend_full(q, k, v, c, q_offset=q_offset, window=window),
                lambda q, k, v, c: tattn._attend_full(q, k, v, c, q_offset=q_offset, window=window))
    return (lambda q, k, v, c: jattn._attend_chunked(q, k, v, c, window=window),
            lambda q, k, v, c: tattn._attend_chunked(q, k, v, c, window=window))


def _close(got, want, tol: float, *, grad: bool = False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = tol * (max(1.0, float(np.abs(want).max())) if grad else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


PAIRS = [("full", c) for c in CASES] + [("chunked", c) for c in CHUNKED]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("fn,case", PAIRS)
def test_matches_jax(fn, case, dtype):
    jcfg, cfg, (jq, jk, jv, _), (q, k, v, _), window, q_offset = _inputs(case, dtype)
    jfn, tfn = _fns(fn, window, q_offset)
    want = jax.jit(lambda q, k, v: jfn(q, k, v, jcfg))(jq, jk, jv)
    got = tfn(q, k, v, cfg)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(_np(got), _np(want), TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("fn,case", PAIRS)
def test_gradients_match_jax(fn, case, dtype):
    jcfg, cfg, (jq, jk, jv, jr), (q, k, v, r), window, q_offset = _inputs(case, dtype, seed=1)
    jfn, tfn = _fns(fn, window, q_offset)
    want = jax.jit(jax.grad(lambda q, k, v: (jfn(q, k, v, jcfg).astype(jnp.float32) * jr).sum(),
                            argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    (tfn(*leaves, cfg).float() * r).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(_np(leaf.grad), _np(w), TOL[dtype], grad=True)


@pytest.mark.parametrize("case", CHUNKED)
def test_chunked_f32_equals_the_plain_reference(case):
    """The oracle of the flash kernels at 32k: exact softmax attention on f32
    inputs, as ``ref.attention_ref`` computes it on all S x T scores."""
    _, cfg, _, (q, k, v, _), window, _ = _inputs(case, "float32", seed=2)
    got = tattn._attend_chunked(q, k, v, cfg, window=window)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window)
    _close(_np(got), _np(want.transpose(1, 2)), TOL["float32"])


def test_no_model_path_calls_the_references(monkeypatch):
    """The port's prefill takes the flash kernel at every length; the xla
    path is a reference only."""
    from repro_torch.models import Model

    def fail(*a, **k):
        raise AssertionError("a model path called an xla-path reference")

    monkeypatch.setattr(tattn, "_attend_full", fail)
    monkeypatch.setattr(tattn, "_attend_chunked", fail)
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), chunk_threshold=4, attention_impl="xla")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    logits, _ = model.forward(params, {"tokens": torch.zeros((1, 16), dtype=torch.int32)})
    assert torch.isfinite(logits.float()).all()
