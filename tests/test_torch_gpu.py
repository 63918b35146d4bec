"""The port on the card (``-m gpu``): each hand-written kernel against its
plain version, and the smoke model's kernel path against its plain path on
the CPU. Skips where there is no CUDA card; imports no JAX, so it runs on a
machine that has none."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rgk
from repro_torch.launch.serve import BatchedServer, make_requests
from repro_torch.models import Model
from repro_torch.models.modules import tree_map_with_path

# tests/test_kernels.py's tolerances
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, None),   # MHA, single block
    (2, 256, 256, 4, 1, 64, None),   # MQA, multi-block
    (1, 384, 384, 4, 2, 128, None),  # GQA, non-square block count
    (1, 100, 100, 2, 2, 64, None),   # ragged
    (1, 128, 256, 2, 2, 64, None),   # cross: kv longer than q
    (1, 256, 256, 2, 2, 64, 16),     # sliding windows
    (1, 256, 256, 2, 2, 64, 64),
    (1, 256, 256, 2, 2, 64, 1024),
    (1, 128, 128, 8, 1, 256, None),  # gemma: MQA, D = 256
    (1, 384, 384, 4, 1, 256, 128),   # recurrentgemma: windowed MQA, D = 256; late rows start on masked tiles
    (2, 64, 64, 4, 2, 16, None),     # smoke head dims
    (2, 40, 40, 6, 2, 8, None),
    # tile edges of the wgmma kernel (128 query rows; 128 keys, 64 at D = 256)
    (1, 200, 200, 4, 2, 128, None),  # ragged S and T across a multiple of 128
    (1, 300, 300, 4, 1, 256, None),
    (1, 100, 300, 4, 2, 128, None),  # S < T
    (1, 260, 130, 2, 1, 256, None),  # S > T
    (1, 512, 512, 4, 4, 128, 200),   # windows that are no multiple of a tile
    (1, 512, 512, 2, 1, 256, 100),
    (2, 256, 256, 4, 4, 128, None),  # Hq / Hkv = 1, 4 and 16 with B > 1
    (2, 256, 256, 16, 4, 128, None),
    (2, 320, 320, 16, 1, 256, 96),
]
# Beside the sweep's tolerance, the wgmma kernel's bf16 output stays within one
# bf16 rounding of the plain version that feeds P as the same two bf16 terms
# (attention_ref(p_bf16=2)): |err| <= 2^-7 |want| + TWO_TERM_ATOL. Both sides
# sum in f32 and round once to bf16, so they part only where the f32 values
# straddle a rounding boundary; the atol covers outputs near 0, where f32
# summation order alone moves the value by ~1e-6.
TWO_TERM_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL[dtype])


def _qkv(card, seed, B, S, T, Hq, Hkv, D, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, S, Hq, D), generator=g, device=card).to(TDT[dtype])
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=card).to(TDT[dtype]) for _ in range(2))
    return q, k, v


def _attention_ref(q, k, v, **kw):
    return ops.ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", FLASH_CASES)
def test_flash_kernel_vs_plain(card, B, S, T, Hq, Hkv, D, window, dtype):
    """Through ops: bf16 at D >= 16 takes the wgmma kernel, the rest the FMA one."""
    q, k, v = _qkv(card, 7, B, S, T, Hq, Hkv, D, dtype)
    wgmma = flash.variant(q.dtype, D) == "wgmma"
    for causal in (True, False):
        before = ops.launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after["flash_attention"] == before["flash_attention"] + 1
        assert after["flash_attention_wgmma"] == before["flash_attention_wgmma"] + wgmma
        _close(got, _attention_ref(q, k, v, causal=causal, window=window), dtype)


BF16_CASES = [c for c in FLASH_CASES if c[5] != 8]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", BF16_CASES)
def test_flash_fma_kernel_vs_plain_in_bf16(card, B, S, T, Hq, Hkv, D, window):
    """The FMA kernel, which ops no longer picks for bf16 at these head dims,
    still holds the bf16 tolerance there."""
    q, k, v = _qkv(card, 7, B, S, T, Hq, Hkv, D, "bf16")
    for causal in (True, False):
        got = flash.launch_fma(q, k, v, causal=causal, window=window)
        _close(got, _attention_ref(q, k, v, causal=causal, window=window), "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", BF16_CASES)
def test_flash_wgmma_kernel_within_one_rounding_of_two_term_p(card, B, S, T, Hq, Hkv, D, window):
    q, k, v = _qkv(card, 11, B, S, T, Hq, Hkv, D, "bf16")
    for causal in (True, False):
        got = flash.launch_wgmma(q, k, v, causal=causal, window=window).float()
        want = _attention_ref(q, k, v, causal=causal, window=window, p_bf16=2).float()
        excess = float(((got - want).abs() - 2.0**-7 * want.abs()).max())
        assert excess <= TWO_TERM_ATOL, (causal, excess)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_inputs(card):
    """q/k/v as views of a fused qkv projection: strides, no copy."""
    g = torch.Generator(device=card).manual_seed(8)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=g, device=card).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = ops.flash_attention(q, k, v)
    want = ops.ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    _close(got, want, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1000, 512), (64, 2560), (300, 16), (5, 3000)])
def test_rmsnorm_kernel_vs_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(shape, generator=g, device=card).to(TDT[dtype])
    s = torch.randn(shape[-1], generator=g, device=card) * 0.1
    before = ops.FUSED_RMSNORM_LAUNCHES
    got = ops.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.FUSED_RMSNORM_LAUNCHES == before + 1
    _close(got, ops.ref.rmsnorm_ref(x, s), dtype)


# tests/test_kernels.py's RG-LRU sweep (B, S, W), then the chunked kernel's
# tiling edges: S at a sub-chunk (8 steps) - 1, + 0, + 1, at a block (32) and
# at a cluster's span (256) - 1, + 0, + 1; S over several rounds; one long
# request; the largest batch; ragged widths 70 and 300 (300 takes 16-byte
# loads in f32 and one element a lane in bf16, 70 one element in both)
SCAN_CASES = [(1, 128, 512), (2, 256, 512), (1, 200, 300), (1, 512, 128), (3, 37, 70),
              (1, 7, 512), (1, 8, 300), (1, 9, 70), (2, 31, 300), (1, 32, 512), (1, 33, 70),
              (1, 255, 300), (1, 256, 70), (1, 257, 256), (2, 1500, 300), (1, 2049, 70),
              (1, 8192, 256), (65535, 3, 4)]


def _scan_inputs(card, B, S, W, dtype, seed=10):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=card)).to(TDT[dtype])
    b = torch.randn((B, S, W), generator=g, device=card).to(TDT[dtype])
    return a, b


def _chunked_model(a, b):
    return ops.ref.rglru_chunked_ref(a, b, rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=rgk.cluster_size(a.shape[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_scan_kernel_vs_plain(card, B, S, W, dtype):
    """Through ops, which launches the chunked kernel; beside the plain
    version, its own order of arithmetic (ref.rglru_chunked_ref) within a
    few f32 roundings, one bf16 rounding for bf16 outputs."""
    a, b = _scan_inputs(card, B, S, W, dtype)
    before = ops.RGLRU_SCAN_LAUNCHES
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.RGLRU_SCAN_LAUNCHES == before + 1
    _close(got, ops.ref.rglru_ref(a, b), dtype)
    torch.testing.assert_close(got.float(), _chunked_model(a, b).float(), rtol=1e-6 if dtype == "f32" else 2**-8,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_sequential_kernel_vs_plain(card, B, S, W, dtype):
    """The kernel the chunked one replaced, kept as its yardstick; its
    counter moves by one a launch."""
    a, b = _scan_inputs(card, B, S, W, dtype)
    before = ops.launch_counts()["rglru_scan_sequential"]
    got = rgk.launch_sequential(a, b)
    assert ops.launch_counts()["rglru_scan_sequential"] == before + 1
    _close(got, ops.ref.rglru_ref(a, b), dtype)


@pytest.mark.gpu
def test_rglru_scan_kernel_carries_state_as_a_running_count(card):
    a = torch.ones((2, 1000, 96), device=card)
    want = torch.arange(1, 1001, dtype=torch.float32, device=card)[None, :, None].expand(2, 1000, 96)
    assert torch.equal(ops.rglru_scan(a, a), want)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [256, 70])
def test_rglru_scan_kernel_bf16_running_sum_is_exact(card, W):
    """a = 1, b = 205/2048 in bf16: the f32 sums (t+1)·b are exact, so h is
    bf16((t+1)·b) bit for bit; a carry rounded to bf16 anywhere is not
    (tests/test_torch_rglru.py shows that it parts)."""
    S = 3000
    a = torch.ones((1, S, W), dtype=torch.bfloat16, device=card)
    b = torch.full((1, S, W), 205 / 2048, dtype=torch.bfloat16, device=card)
    want = (torch.arange(1, S + 1, dtype=torch.float32, device=card) * (205 / 2048)).bfloat16()
    assert torch.equal(ops.rglru_scan(a, b), want[None, :, None].expand(1, S, W))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("W", [512, 70])
def test_rglru_scan_kernel_resets_where_a_is_zero(card, dtype, W):
    """a = 0 at every sub-chunk's start: h there is b exactly, and after it
    the chunked kernel runs the same FMA chain as the sequential one, so the
    two agree bit for bit whatever the carries."""
    a, b = _scan_inputs(card, 2, 1100, W, dtype, seed=12)
    a[:, :: rgk.SUB_CHUNK] = 0
    got = ops.rglru_scan(a, b)
    assert torch.equal(got[:, :: rgk.SUB_CHUNK], b[:, :: rgk.SUB_CHUNK])
    assert torch.equal(got, rgk.launch_sequential(a, b))


@pytest.mark.gpu
def test_rglru_scan_kernel_holds_f32_on_slow_decays(card):
    """a in [0.99, 1) over 4096 steps (the RG-LRU's slow channels): the inputs
    of tests/test_torch_rglru.py's CPU test of the chunked model; f32 2e-5."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.99, 1.0, (1, 4096, 256)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32)).to(card)
    _close(ops.rglru_scan(a, b), ops.ref.rglru_ref(a, b), "f32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_kernel_is_deterministic(card, dtype):
    a, b = _scan_inputs(card, 2, 4096, 512, dtype, seed=13)
    assert torch.equal(ops.rglru_scan(a, b), ops.rglru_scan(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_kernel_reads_misaligned_inputs(card, dtype):
    """Contiguous views 4 or 2 bytes off a 16-byte boundary take the kernel's
    one-element loads; the result is the same."""
    B, S, W = 2, 300, 512
    a, b = _scan_inputs(card, B, S, W, dtype, seed=14)
    a_off = torch.empty(B * S * W + 1, dtype=a.dtype, device=card)[1:].view(B, S, W).copy_(a)
    b_off = torch.empty(B * S * W + 1, dtype=b.dtype, device=card)[1:].view(B, S, W).copy_(b)
    assert a_off.data_ptr() % 16 and a_off.is_contiguous()
    assert torch.equal(ops.rglru_scan(a_off, b_off), ops.rglru_scan(a, b))


# The launches of one smoke forward: one flash per attn layer, each on the
# wgmma kernel (bf16 at head dim 16), two RMSNorms per layer (four with
# qk-norms) plus the final one, one scan per rec layer.
SMOKE_FORWARD_LAUNCHES = {
    # 3 attn layers, qk-norms
    "qwen3-4b": {"flash_attention": 3, "flash_attention_wgmma": 3, "fused_rmsnorm": 13, "rglru_scan": 0,
                 "rglru_scan_sequential": 0},
    # 2 attn layers
    "gemma-2b": {"flash_attention": 2, "flash_attention_wgmma": 2, "fused_rmsnorm": 5, "rglru_scan": 0,
                 "rglru_scan_sequential": 0},
    # one (rec, rec, attn) unit + two remainder rec layers
    "recurrentgemma-9b": {"flash_attention": 1, "flash_attention_wgmma": 1, "fused_rmsnorm": 11, "rglru_scan": 4,
                          "rglru_scan_sequential": 0},
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(SMOKE_FORWARD_LAUNCHES))
def test_smoke_model_kernel_path_vs_plain_path(card, arch):
    """The same weights and tokens through the kernels on the card and the
    plain versions on the CPU. The bound is the decode/prefill one of the
    CPU tests (0.1): matrix products differ in summation order between the
    card and the CPU."""
    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=card), Model(cfg, device="cpu")
    params = gpu.init(torch.Generator(device=card).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    ops.reset_launch_counts()
    got, _ = gpu.forward(params, {"tokens": tokens.to(card)})
    assert ops.launch_counts() == SMOKE_FORWARD_LAUNCHES[arch]
    want, _ = cpu.forward(tree_map_with_path(lambda _, a: a.cpu(), params), {"tokens": tokens})
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err < 0.1, err


@pytest.mark.gpu
def test_smoke_server_on_card_launches_the_norm_kernel(card):
    cfg = get_config("qwen3-4b", smoke=True)
    server = BatchedServer(Model(cfg, device=card), batch=3, max_len=64)
    ops.reset_launch_counts()
    stats = server.run(make_requests(cfg.vocab, 6, 4))
    assert stats["requests_done"] == 6
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "flash_attention_wgmma": 0,
        "fused_rmsnorm": (4 * cfg.n_layers + 1) * stats["decode_steps"],
        "rglru_scan": 0,
        "rglru_scan_sequential": 0,
    }


@pytest.mark.gpu
def test_hybrid_smoke_server_on_card(card):
    """recurrentgemma-9b smoke served on the card: decode steps the recurrent
    state in plain PyTorch, so only the norm kernel launches."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    server = BatchedServer(Model(cfg, device=card), batch=3, max_len=64)
    ops.reset_launch_counts()
    stats = server.run(make_requests(cfg.vocab, 6, 4))
    assert stats["requests_done"] == 6
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "flash_attention_wgmma": 0,
        "fused_rmsnorm": (2 * cfg.n_layers + 1) * stats["decode_steps"],
        "rglru_scan": 0,
        "rglru_scan_sequential": 0,
    }
    assert server.state["remainder"]["layer4"]["h"].abs().sum() > 0
