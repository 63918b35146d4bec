"""Child-process entrypoint: run one fault-scenario driver under an Agent.

The harness spawns one of these per simulated host.  The child builds the
scenario's driver, warms it up (allocates the model on its device, compiles
the Triton kernels, primes pipelines) *before* starting the profiling agent —
so the published profile is the steady-state workload, not startup — then
loops ``driver.step()`` until the harness drops a ``stop`` sentinel in the
control directory.

Control protocol (files in ``--ctl``):
  harness -> child:  ``inject``, ``clear``, ``stop`` (touched once, in order)
  child -> harness:  ``ready.<host_index>`` (written after the agent starts)

The control poller runs on a thread named ``repro-prof-faults-ctl`` so the
sampler excludes it from profiles — the ground-truth machinery must never
appear in the data being scored.

A copy of ``repro.faults._target`` for the port. ``--device`` and ``--smoke``
place a model driver. Where the driver imported torch, the child prints one
JSON line to its log on exit (``{"faults_child": <host index>, ...}``): the
device's name, the kernel launches of the stepped loop (from
``repro_torch.kernels.ops.launch_counts``), the agent's ticks when the fault
was injected and cleared, and the driver's :meth:`~.base.Driver.summary`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from repro_torch.faults.base import ScenarioContext
from repro_torch.faults.scenarios import SCENARIOS
from repro_torch.profilerd.agent import Agent


def _torch_report(device: str, launches0: dict) -> dict:
    import torch

    from repro_torch.kernels import ops

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    launches = {k: n - launches0.get(k, 0) for k, n in ops.launch_counts().items()}
    return {"device": name, "kernel_launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.faults._target")
    ap.add_argument("--scenario", required=True)
    ap.add_argument("--spool", required=True)
    ap.add_argument("--ctl", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--period", type=float, default=0.004)
    ap.add_argument("--device", default="cuda", help="a model driver's torch device: cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="a model driver takes its config's smoke size")
    args = ap.parse_args(argv)

    scenario = SCENARIOS[args.scenario]
    ctx = ScenarioContext(args.host_index, args.n_hosts, args.workdir, device=args.device, smoke=args.smoke)
    driver = scenario.make_driver(ctx)
    driver.warmup()
    launches0 = {}
    if "torch" in sys.modules:  # count the stepped loop's launches, not the warm-up's
        from repro_torch.kernels import ops

        launches0 = ops.launch_counts()

    stop = threading.Event()
    driver.stop_event = stop  # drivers with blocking waits bail on shutdown
    ticks: dict[str, int] = {}

    def poll_ctl() -> None:
        seen: set[str] = set()
        while not stop.is_set():
            for op in ("inject", "clear", "stop"):
                if op in seen or not os.path.exists(os.path.join(args.ctl, op)):
                    continue
                seen.add(op)
                ticks[f"at_{op}"] = agent.n_ticks
                if op == "inject":
                    driver.inject()
                elif op == "clear":
                    driver.clear()
                else:
                    stop.set()
                    return
            time.sleep(0.02)

    poller = threading.Thread(target=poll_ctl, name="repro-prof-faults-ctl", daemon=True)

    agent = Agent(args.spool, period_s=args.period)
    agent.start()
    poller.start()
    # Ready only after the agent is live: the harness's daemon attach then
    # finds a spool with a HELLO already in it.
    ready = os.path.join(args.ctl, f"ready.{args.host_index}")
    with open(ready + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.rename(ready + ".tmp", ready)

    try:
        while not stop.is_set():
            driver.step()
    finally:
        driver.close()
        agent.stop()  # writes BYE so the daemon sees a clean detach
    if "torch" in sys.modules:
        ticks["total"] = agent.n_ticks
        report = {"faults_child": args.host_index, **_torch_report(args.device, launches0),
                  "agent_ticks": ticks, **driver.summary()}
        print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
