"""Top-level Model API: spec / init / forward / loss / decode.

``Model`` is the entry point the server, the trainer, ``chip_smoke.py`` and
the tests share. Activations are bf16, as in the JAX package. A model lives
on one device, ``cuda`` unless the caller asks for the CPU: on the card every
norm and the prefill attention run the hand-written kernels (and, under
autograd, their hand-written backward kernels), on the CPU their plain
versions. ``forward`` and ``loss`` follow the caller's autograd mode: the
trainer differentiates them, the server and ``chip_smoke.py``'s prefill run
them under ``torch.inference_mode()``. ``forward``, ``loss`` and
``decode_step`` run under the JAX package's scopes ``model``, ``loss`` and
``decode`` (``core/scope.py``). ``input_specs``, ``model_flops`` and
``abstract_decode_state`` serve the dry-run (``launch/dryrun.py``), which
runs a model on the meta device.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.scope import scope
from repro_torch.sharding.ctx import shard_activation

from . import transformer as tfm
from .modules import (
    ArraySpec,
    dtype_const,
    embed,
    embedding_spec,
    init_params,
    lm_head,
    lm_head_spec,
    param_count,
    rms_norm,
    rms_norm_spec,
    tree_leaves,
    unembed,
)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain versions on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters -----------------------------------------------------------

    def spec(self) -> dict:
        cfg = self.cfg
        spec: dict[str, Any] = {}
        if cfg.input_mode == "tokens":
            spec["embed"] = embedding_spec(cfg.vocab, cfg.d_model)
        else:
            # The modality frontend is a stub, as in the JAX package: inputs
            # arrive as precomputed frame or patch embeddings.
            spec["embed_proj"] = {"w": ArraySpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"))}
        spec["layers"] = tfm.stack_spec(cfg)
        spec["final_norm"] = rms_norm_spec(cfg.d_model)
        if not cfg.tied_embeddings:
            spec["lm_head"] = lm_head_spec(cfg.vocab, cfg.d_model)
        return spec

    def init(self, generator: torch.Generator | None = None, *, train: bool = False) -> dict:
        """Random parameters on the model's device (seed 0 unless a generator
        on that device is given). ``train`` stores every parameter in f32, as
        the JAX package trains them; otherwise the matrix weights the model
        only ever reads in bf16 are stored in bf16 (``storage_dtype``)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return init_params(self.spec(), generator, train=train)

    @staticmethod
    def grad_leaves(params, grads) -> dict:
        """A params tree for one forward and backward pass whose gradients are
        added into ``grads`` (f32, the params' structure) in place.

        Each leaf is a new autograd leaf that shares its parameter's memory,
        with ``.grad`` set to its place in ``grads``; autograd adds into a
        ``.grad`` that is already there, so microbatches sum where they lie.
        The layer stack's stacked weights become per-unit leaves
        (``transformer.stack_grad_leaves``)."""

        def leaf(p, g):
            t = p.detach().requires_grad_(True)
            t.grad = g
            return t

        def tree(p, g):
            return {k: tree(p[k], g[k]) for k in p} if isinstance(p, dict) else leaf(p, g)

        return {k: tfm.stack_grad_leaves(v, grads[k], leaf) if k == "layers" else tree(v, grads[k])
                for k, v in params.items()}

    @property
    def n_params(self) -> int:
        return param_count(self.spec())

    @property
    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: the routed experts count k/E), as
        the JAX package counts them."""
        cfg = self.cfg
        total = self.n_params
        if not cfg.n_experts:
            return total
        routed = sum(math.prod(s.shape) for path, s in tree_leaves(self.spec())
                     if "moe" in path and "router" not in path and "expert" in s.logical)
        return int(total - routed + routed * cfg.top_k / cfg.n_experts)

    # -- forward ----------------------------------------------------------------

    def _embed(self, params, batch: dict) -> torch.Tensor:
        """The bf16 activations of ``batch["tokens"]`` (B,S), or, where the
        config takes embeddings, of ``batch["embeds"]`` (B,S,D): their bf16
        product with ``embed_proj``."""
        if self.cfg.input_mode == "tokens":
            x = embed(params["embed"], batch["tokens"]).to(torch.bfloat16)
        else:
            x = batch["embeds"].to(torch.bfloat16) @ params["embed_proj"]["w"].to(torch.bfloat16)
        if self.cfg.tied_embeddings:
            # gemma convention; JAX rounds the constant to bf16 first
            x = x * dtype_const(math.sqrt(self.cfg.d_model), x.dtype)
        return x

    def logits_fn(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = unembed(params["embed"], x) if cfg.tied_embeddings else lm_head(params["lm_head"], x)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits

    def forward(self, params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens": (B,S)} or {"embeds": (B,S,D)} as the config's
        ``input_mode`` says, and optionally "positions", (B,S) or, with
        M-RoPE, (B,S,3) (temporal, height, width); by default 0..S-1, in each
        of the three streams with M-RoPE. -> (logits (B,S,V), the MoE
        load-balance loss summed over the layers (an f32 0 without an MoE))."""
        with scope("model"):
            return self._forward(params, batch)

    def _forward(self, params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        x = shard_activation(self._embed(params, batch), ("batch", None, None))
        positions = batch.get("positions")
        if positions is None:
            B, S = x.shape[:2]
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
            if self.cfg.mrope:
                positions = positions[..., None].expand(B, S, 3)
        x, x_sum, lb = tfm.stack_apply(params["layers"], x, self.cfg, positions)
        x = rms_norm(params["final_norm"], x if x_sum is None else x_sum, scope="final_norm").to(x.dtype)
        return self.logits_fn(params, x), lb

    def loss(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Causal-LM cross entropy + 1e-4 z-loss + 1e-2 load-balance loss, as
        the JAX package's ``Model.loss``: log-softmax in f32, the mean over
        ``loss_mask`` (all ones when absent) with its sum floored at 1.
        -> (total, {"ce", "z_loss", "lb_loss"}), all 0-d f32 tensors."""
        with scope("loss"):
            return self._loss(params, batch)

    def _loss(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        logits, lb = self.forward(params, batch)
        logits = logits.float()
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, batch["labels"].long()[..., None])[..., 0]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(nll) if mask is None else mask.float()
        denom = mask.sum().clamp_min(1.0)
        ce = (nll * mask).sum() / denom
        zl = 1e-4 * (torch.logsumexp(logits, dim=-1).square() * mask).sum() / denom
        return ce + zl + 1e-2 * lb, {"ce": ce, "z_loss": zl, "lb_loss": lb}

    # -- decode -------------------------------------------------------------------

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        return tfm.stack_state(self.cfg, batch, max_len, self.device)

    def abstract_decode_state(self, batch: int, max_len: int) -> dict:
        """The decode state's shapes and dtypes, as meta tensors."""
        return tfm.stack_state(self.cfg, batch, max_len, "meta")

    @torch.inference_mode()
    def decode_step(self, params, batch: dict, state: dict, pos: int) -> tuple[torch.Tensor, dict]:
        """One new token for every sequence. batch: {'tokens': (B,1)} or
        {'embeds': (B,1,D)}; pos: int (all three M-RoPE streams take it).
        -> (logits (B,V), state), the state updated in place."""
        with scope("decode"):
            x = self._embed(params, batch)
            x, x_sum = tfm.stack_decode(params["layers"], x, state, pos, self.cfg)
            x = rms_norm(params["final_norm"], x if x_sum is None else x_sum, scope="final_norm").to(x.dtype)
            return self.logits_fn(params, x)[:, 0], state

    # -- dry-run input specs --------------------------------------------------------

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Meta-tensor stand-ins for every model input of this workload, of
        the JAX package's shapes and dtypes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16

        def spec(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        S_in = S if shape.kind in ("train", "prefill") else 1  # decode: one new token against a state of S
        batch: dict[str, Any] = {}
        if cfg.input_mode == "tokens":
            batch["tokens"] = spec((B, S_in), i32)
        else:
            batch["embeds"] = spec((B, S_in, cfg.d_model), bf16)
        if shape.kind == "decode":
            return batch
        if cfg.mrope:
            batch["positions"] = spec((B, S, 3), i32)
        if shape.kind == "train":
            batch["labels"] = spec((B, S), i32)
            batch["loss_mask"] = spec((B, S), f32)
        return batch

    # -- cost model ---------------------------------------------------------------------

    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS napkin: 6*N*D (dense) / 6*N_active*D (MoE); decode uses
        D = new tokens (global_batch) and 2*N_active (no backward)."""
        n = self.n_active_params
        if shape.kind == "train":
            return 6.0 * n * shape.tokens
        if shape.kind == "prefill":
            return 2.0 * n * shape.tokens
        return 2.0 * n * shape.global_batch
