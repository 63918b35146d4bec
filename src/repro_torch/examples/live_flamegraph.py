"""Live flamegraph walkthrough: profile a running workload, query it over
HTTP *while it runs*, and save a self-contained flamegraph (the counterpart
of the JAX package's ``examples/live_flamegraph.py``, on the port's
profiling plane).

The whole read side of the profiling plane in one script, no torch required:

1. park a worker in a busy loop and publish raw frames through the
   out-of-process agent (the target never resolves a symbol);
2. attach a :class:`~repro_torch.profilerd.daemon.ProfilerDaemon` with the HTTP
   query plane enabled (``serve_port=0`` binds an ephemeral port);
3. poll ``/status`` and print ``profilerd top`` frames while ingestion is
   still streaming;
4. save ``/tree?fmt=html`` (interactive flamegraph), ``fmt=folded``
   (FlameGraph/speedscope interchange) and a library view, then shut down.

Run it::

    PYTHONPATH=src python -m repro_torch.examples.live_flamegraph

The equivalent from two shells, against a real job::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --profile \\
        --backend daemon --spool /tmp/serve.spool        # terminal 1
    PYTHONPATH=src python -m repro_torch.profilerd attach \\
        --spool /tmp/serve.spool --serve 8787            # terminal 2
    PYTHONPATH=src python -m repro_torch.profilerd top --url http://127.0.0.1:8787
"""

import os
import tempfile
import threading
import time
import urllib.request

from repro_torch.profilerd.agent import Agent
from repro_torch.profilerd.daemon import DaemonConfig, ProfilerDaemon
from repro_torch.profilerd.server import fetch_status, render_top


def tokenize(chunk):  # a recognizable hot path for the flamegraph
    return sum(len(w) for w in chunk.split())


def serve_request(n):
    total = 0
    for _ in range(200):
        total += tokenize("the quick brown fox " * 50)
    return total


def worker(stop):
    n = 0
    while not stop.is_set():
        serve_request(n)
        n += 1


def main() -> int:
    out = tempfile.mkdtemp(prefix="live_flamegraph_")
    spool = os.path.join(out, "job.spool")

    # 1. the "job": a busy worker thread + the raw-frame agent.
    stop = threading.Event()
    t = threading.Thread(target=worker, args=(stop,), name="serve-worker", daemon=True)
    t.start()
    agent = Agent(spool, period_s=0.02)
    agent.start()

    # 2. the observer: daemon + live HTTP query plane (out-of-process in real
    # deployments; a thread here so the example is one file).
    cfg = DaemonConfig(
        spool_path=spool,
        out_dir=os.path.join(out, "profile"),
        publish_interval_s=0.2,
        epoch_s=0.5,
        max_seconds=60,
        serve_port=0,
    )
    daemon = ProfilerDaemon(cfg)
    daemon.attach()
    server = daemon.enable_serving()
    runner = threading.Thread(target=daemon.run, daemon=True)
    runner.start()
    print(f"live query plane: {server.url}  (endpoints: /status /tree /timeline /diff)\n")

    # 3. watch it run: three `top` frames over the live HTTP API.
    for _ in range(3):
        time.sleep(1.0)
        print(render_top(fetch_status(server.url), server.url, k=5))
        print("-" * 72)

    # 4. export while still live: flamegraph HTML + folded stacks + a view.
    artifacts = {}
    for name, query in [
        ("flamegraph.html", "/tree?fmt=html"),
        ("profile.folded", "/tree?fmt=folded"),
        ("profile.speedscope.json", "/tree?fmt=speedscope"),
        ("host_threads.csv", "/tree?view=host_threads"),
    ]:
        path = os.path.join(out, name)
        with urllib.request.urlopen(server.url + query) as resp, open(path, "wb") as f:
            f.write(resp.read())
        artifacts[name] = path

    agent.stop()  # BYE -> the daemon drains, final-publishes and exits run()
    stop.set()
    runner.join(timeout=30)

    print("\nartifacts:")
    for name, path in artifacts.items():
        print(f"  {name:28s} {os.path.getsize(path):8d} bytes  {path}")
    print(f"\nopen {artifacts['flamegraph.html']} in a browser — click frames to zoom.")
    print("feed profile.folded to flamegraph.pl, or drop profile.speedscope.json")
    print("on speedscope; `python -m repro_torch.profilerd serve --profile "
          f"{cfg.resolved_out_dir()}` re-serves this run offline.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
