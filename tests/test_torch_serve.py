"""The port's batched server on the CPU, against the JAX package's server."""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.serve import BatchedServer as JaxServer  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request, main  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

ARCH = "qwen3-4b"


@pytest.fixture(scope="module")
def servers():
    """A JAX server and a port server on the CPU holding the same weights."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), attention_impl="pallas_interpret")
    jserver = JaxServer(JaxModel(jcfg), batch=3, max_len=64)
    cfg = get_config(ARCH, smoke=True)
    server = BatchedServer(Model(cfg, device="cpu"), batch=3, max_len=64)
    server.params = params_from_numpy(jax.tree.map(np.asarray, jserver.params), cfg, "cpu")
    return jserver, server


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 4).astype(np.int32), max_new=4) for i in range(6)]


def test_server_completes_requests_through_slots(servers):
    jserver, server = servers
    vocab = server.model.cfg.vocab
    reqs, jreqs = _requests(Request, vocab), _requests(JaxRequest, vocab)
    stats = server.run(reqs)
    jstats = jserver.run(jreqs)
    assert stats["requests_done"] == 6  # 6 requests through 3 slots
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["metrics"]["requests_done"] == 6
    assert all(len(r.out) == 4 and all(0 <= t < vocab for t in r.out) for r in reqs)
    # greedy tokens agree: decode logits match to ~1e-4 at this config
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_hybrid_server_completes_requests_through_slots():
    """recurrentgemma-9b smoke through 3 slots: reused slots keep the previous
    occupant's conv window and h (and ring-buffer KV), as in the JAX server,
    so the greedy tokens agree only if the port reproduces that."""
    arch = "recurrentgemma-9b"
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), attention_impl="pallas_interpret")
    jserver = JaxServer(JaxModel(jcfg), batch=3, max_len=64)
    cfg = get_config(arch, smoke=True)
    server = BatchedServer(Model(cfg, device="cpu"), batch=3, max_len=64)
    server.params = params_from_numpy(jax.tree.map(np.asarray, jserver.params), cfg, "cpu")
    reqs, jreqs = _requests(Request, cfg.vocab), _requests(JaxRequest, cfg.vocab)
    stats, jstats = server.run(reqs), jserver.run(jreqs)
    assert stats["requests_done"] == 6 and stats["decode_steps"] == jstats["decode_steps"]
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert server.state["remainder"]["layer4"]["h"].abs().sum() > 0


def test_moe_server_completes_requests_through_slots():
    """deepseek-moe-16b smoke through 3 slots, the JAX server beside it on the
    same weights: each decode step routes the batch's 3 tokens as one batch
    (capacity 8), and the greedy tokens agree."""
    arch = "deepseek-moe-16b"
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), attention_impl="pallas_interpret")
    jserver = JaxServer(JaxModel(jcfg), batch=3, max_len=64)
    cfg = get_config(arch, smoke=True)
    server = BatchedServer(Model(cfg, device="cpu"), batch=3, max_len=64)
    server.params = params_from_numpy(jax.tree.map(np.asarray, jserver.params), cfg, "cpu")
    reqs, jreqs = _requests(Request, cfg.vocab), _requests(JaxRequest, cfg.vocab)
    stats, jstats = server.run(reqs), jserver.run(jreqs)
    assert stats["requests_done"] == 6 and stats["decode_steps"] == jstats["decode_steps"]
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_serve_step_logits_match_jax_on_same_tokens_and_state(servers):
    jserver, server = servers
    cfg = server.model.cfg
    jdecode = jax.jit(jserver.model.decode_step)
    # a non-trivial state: a few JAX decode steps, then the same state in both
    jstate = jserver.model.init_decode_state(3, 16)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    for t in range(5):
        _, jstate = jdecode(jserver.params, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
    state = jax.tree.map(lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16(), jstate)
    batch = {"tokens": torch.from_numpy(toks[:, 5:6])}
    want, _ = jdecode(jserver.params, {"tokens": jnp.asarray(toks[:, 5:6])}, jstate, jnp.int32(5))
    got, _ = server.model.decode_step(server.params, batch, jax.tree.map(torch.clone, state), 5)
    assert got.shape == (3, cfg.vocab)
    err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())
    assert err < 0.05, err
    # the serve step is the greedy argmax of those logits, as JAX's serve step is
    jtok, _ = jax.jit(jax_serve_step(jserver.model))(jserver.params, {"tokens": jnp.asarray(toks[:, 5:6])},
                                                      jstate, jnp.int32(5))
    tok, _ = make_serve_step(server.model)(server.params, batch, state, 5)
    assert torch.equal(tok, torch.argmax(got, dim=-1).to(torch.int32))
    assert tok.tolist() == np.asarray(jtok).tolist()


def test_greedy_serve_step_returns_int32_tokens():
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok, _ = make_serve_step(model)(params, {"tokens": torch.zeros((2, 1), dtype=torch.int64)},
                                    model.init_decode_state(2, 8), 0)
    assert tok.dtype == torch.int32 and tok.shape == (2,)


def test_server_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(Model(get_config(ARCH, smoke=True)), batch=2, max_len=16)


def test_cli_serves_on_the_cpu(capsys):
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert '"requests_done": 3' in out and '"device": "cpu"' in out


def test_cli_serves_moe_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek-moe-16b --device cpu``."""
    main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--requests", "3", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert '"requests_done": 3' in out and '"device": "cpu"' in out


def test_cli_defaults_to_gemma_2b_as_the_jax_server(capsys, monkeypatch):
    import repro_torch.launch.serve as serve

    archs = []
    monkeypatch.setattr(serve, "get_config", lambda arch, smoke: archs.append((arch, smoke)) or get_config(arch,
                                                                                                           smoke=smoke))
    main(["--device", "cpu", "--requests", "2", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert archs == [("gemma-2b", True)]
    assert '"requests_done": 2' in out and "profile_samples" not in out


def test_cli_profiles_on_the_thread_backend(capsys):
    """``--profile``: the host-plane sampler and the dominance watchdog run
    beside the serving loop (the JAX server's wiring); the stats gain the
    samples taken and the anomalies the watchdog saw."""
    main(["--arch", "xlstm-125m", "--device", "cpu", "--requests", "8", "--batch", "2", "--max-new", "8",
          "--profile"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["requests_done"] == 8 and stats["profile_samples"] > 0 and stats["anomalies"] == []


def test_cli_daemon_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        main(["--device", "cpu", "--profile", "--backend", "daemon"])
