"""Federated observability smoke check on the PyTorch port (the twin of
the ``make federation-scrape-smoke`` target).

Two federation hosts (``examples_torch/federation_host.py`` — each a full
FleetGroup: scope-sharded ConsensusFleet behind a bridge server) run as
REAL OS processes on ``--device`` (passed on to both hosts: the card by
default, raising without a GPU), a :class:`~hashgraph_tpu_torch.parallel.
federation.FederationDriver` drives one decision onto each host, and the
smoke then asserts the metric-federation plane end to end:

- ``OP_METRICS_PULL`` returns one frame per host (registry export +
  SLO state, stamped with the host label);
- the merged Prometheus view carries BOTH hosts' families labelled
  ``host="..."`` plus the bare fleet-total sums, including the
  decision-latency histogram the decisions above populated;
- the merged ``/slo`` rollup keys both hosts and counts the windowed
  decisions fleet-wide;
- an HTTP sidecar serving the MERGED views (``render_fn``/``slo_fn``
  hooks) scrapes identically over the wire — one scrape, every host.

Exit code 0 and a final ``federation-scrape-smoke OK`` line mean a
single pager's dashboard can watch the whole fleet through one endpoint.

Run: python examples_torch/federation_scrape_smoke.py [--device cuda|cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import urllib.request

sys.path.insert(0, ".")  # run from the repo root

NOW = 1_700_000_000
V_COUNT = 4
HOST_IDS = ["h0", "h1"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args().device

    from hashgraph_tpu_torch import build_vote
    from hashgraph_tpu_torch.bridge.client import BridgeClient
    from hashgraph_tpu_torch.obs import registry as default_registry
    from hashgraph_tpu_torch.obs.http import MetricsSidecar
    from hashgraph_tpu_torch.parallel.federation import (
        FederationDriver,
        FederationPlacement,
    )
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner
    from hashgraph_tpu_torch.wire import Proposal

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runner = os.path.join(repo, "examples_torch", "federation_host.py")
    placement = FederationPlacement.uniform(HOST_IDS, 2)

    procs: "dict[str, subprocess.Popen]" = {}
    clients: "dict[str, BridgeClient]" = {}
    peer_ids: "dict[str, int]" = {}
    driver = None
    sidecar = None
    try:
        for host_id in HOST_IDS:
            procs[host_id] = subprocess.Popen(
                [sys.executable, runner,
                 "--host-id", host_id,
                 "--hosts", ",".join(HOST_IDS),
                 "--shards-per-host", "2",
                 "--capacity", "32",
                 "--voter-capacity", str(V_COUNT + 2),
                 "--device", device],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                cwd=repo,
            )
        driver = FederationDriver(placement)
        for host_id, proc in procs.items():
            line = proc.stdout.readline().decode()
            assert line.startswith("READY "), f"host runner said: {line!r}"
            _, port_s, peer_s = line.split()
            peer_ids[host_id] = int(peer_s)
            clients[host_id] = BridgeClient(
                "127.0.0.1", int(port_s), timeout=30.0
            )
            driver.connect(host_id, "127.0.0.1", int(port_s), int(peer_s))

        # One decision PER HOST so every host's decision-latency window
        # has something to report: pick scope names until each host owns
        # at least one, then drive its vote chain through the driver.
        scopes: "dict[str, str]" = {}
        i = 0
        while len(scopes) < len(HOST_IDS):
            scope = f"scrape-{i}"
            i += 1
            owner, _shard = placement.owner(scope)
            scopes.setdefault(owner, scope)
        signers = [StubConsensusSigner(os.urandom(20)) for _ in range(V_COUNT)]
        for owner, scope in scopes.items():
            _owner, shard = placement.owner(scope)
            pid, blob = clients[owner].create_proposal(
                peer_ids[owner], scope, NOW, "p", b"payload", V_COUNT, 3_600
            )
            placement.pin(scope, shard)
            proposal = Proposal.decode(blob)
            votes = []
            for signer in signers:
                vote = build_vote(proposal, True, signer, NOW + 1)
                proposal.votes.append(vote)
                votes.append(vote.encode())
            driver.submit(scope, votes, NOW + 1)
            driver.pump()
        report = driver.drain()
        assert report["acked"] == len(HOST_IDS) * V_COUNT, report

        # One OP_METRICS_PULL frame per host, each self-labelled.
        frames = driver.pull_metric_frames()
        assert sorted(f["host"] for f in frames) == HOST_IDS, frames

        merged_text = driver.merged_metrics_text()
        for host_id in HOST_IDS:
            assert f'host="{host_id}"' in merged_text, (
                f"merged scrape missing host label {host_id!r}"
            )
        assert "hashgraph_decision_latency_seconds_bucket" in merged_text
        # The bare (unlabelled) family is the fleet-total sum — it must
        # coexist with the per-host labelled series in one scrape.
        assert "\nbridge_requests_total " in merged_text, (
            "merged scrape missing the bare fleet-total series"
        )

        merged_slo = driver.merged_slo()
        assert sorted(merged_slo["hosts"]) == HOST_IDS, merged_slo
        assert merged_slo["global"]["count"] >= len(HOST_IDS), merged_slo
        assert merged_slo["alerts_firing"] == [], merged_slo

        # The same merged views over HTTP: the single endpoint a fleet
        # dashboard scrapes.
        sidecar = MetricsSidecar(
            default_registry,
            host="127.0.0.1",
            port=0,
            render_fn=driver.merged_metrics_text,
            slo_fn=driver.merged_slo,
        )
        mhost, mport = sidecar.start()
        with urllib.request.urlopen(
            f"http://{mhost}:{mport}/metrics", timeout=5
        ) as response:
            scraped = response.read().decode("utf-8")
        for host_id in HOST_IDS:
            assert f'host="{host_id}"' in scraped, host_id
        with urllib.request.urlopen(
            f"http://{mhost}:{mport}/slo", timeout=5
        ) as response:
            scraped_slo = json.loads(response.read())
        assert sorted(scraped_slo["hosts"]) == HOST_IDS, scraped_slo
    finally:
        if sidecar is not None:
            sidecar.stop()
        if driver is not None:
            driver.close()
        for client in clients.values():
            client.close()
        for proc in procs.values():
            try:
                proc.stdin.close()  # EOF = the runner's shutdown signal
                proc.wait(timeout=15)
            except Exception:
                proc.kill()

    print("federation-scrape-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
