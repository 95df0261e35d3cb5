"""Standalone federation host on the PyTorch port: one FleetGroup in its
own OS process.

The federation's point is throughput ACROSS hosts — in-process "hosts"
share one GIL, so an aggregate number measured there is one
interpreter's ceiling, not a fleet's. This runner hosts one
:class:`~hashgraph_tpu_torch.parallel.federation.FleetGroup` (a
scope-sharded ``ConsensusFleet`` fronted by a bridge server whose single
peer is the fleet adapter) as a real OS process:

    python examples_torch/federation_host.py --host-id h0 --hosts h0,h1 \\
        [--shards-per-host N] [--capacity N] [--voter-capacity N] \\
        [--wal-root DIR] [--device cuda|cpu]

``--device cuda`` (the default) spreads the shards over every visible GPU
and raises without one; ``--device cpu`` holds them on the CPU. Every
participant passes the SAME ``--hosts`` list and shard count, so each
process reconstructs the identical two-level rendezvous placement.
It prints ``READY <port> <peer_id>`` once listening, then serves one
command per stdin line (one response line on stdout each) until EOF —
the parent closing the pipe is the shutdown signal:

    EXPORT <shard_id> [retry_after_seconds]
        Freeze the shard for migration (wire refusals carry the
        retry-after hint), register its durable engine as a sync peer
        -> ``EXPORTED <peer_id> <fingerprint>``
    ADOPT <shard_id> <host> <port> <peer_id>
        Catch the shard up from a source peer (snapshot at its frozen
        WAL watermark + tail) -> ``ADOPTED <sessions> <fingerprint>``
    FLIP <shard_id> <to_host>
        Re-home the shard in this host's placement (the driver sends it
        to every host after a successful adopt) -> ``FLIPPED``
    RETIRE <shard_id> <peer_id>
        Drop the migrated shard + its temporary sync peer -> ``RETIRED``
    TALLY
        Local fleet state counts -> ``TALLY <json>``
    SLOCFG <scope> <decide_p99_ms>
        Declare a decide-latency SLO objective on a scope of this
        host's fleet -> ``SLOCFG``  (the SLO engine starts alerting on
        it; ``OP_METRICS_PULL`` / the merged ``/slo`` view report it)
    SLOSET <0|1>
        Toggle the process-wide SLO engine (the overhead-A/B kill
        switch) -> ``SLOSET <0|1>``

A benchmark spawns one of these per host; it is also a handy way to run
a real multi-process federation by hand.
"""

import argparse
import json
import shlex
import sys
import tempfile

sys.path.insert(0, ".")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host-id", required=True)
    parser.add_argument(
        "--hosts", required=True,
        help="comma-separated host ids, identical on every participant",
    )
    parser.add_argument("--shards-per-host", type=int, default=2)
    parser.add_argument("--capacity", type=int, default=256)
    parser.add_argument("--voter-capacity", type=int, default=66)
    parser.add_argument("--wal-root", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()

    import torch

    from hashgraph_tpu_torch.parallel.federation import (
        FederationPlacement,
        FleetGroup,
    )
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner

    wal_root = args.wal_root or tempfile.mkdtemp(prefix="federation-wal-")
    placement = FederationPlacement.uniform(
        args.hosts.split(","), args.shards_per_host
    )
    group = FleetGroup(
        args.host_id,
        lambda k: StubConsensusSigner(
            args.host_id.encode().ljust(12, b"\0") + bytes([k + 1]) * 8
        ),
        placement=placement,
        wal_root=wal_root,
        capacity_per_shard=args.capacity,
        voter_capacity=args.voter_capacity,
        devices=None if args.device == "cuda" else [torch.device("cpu")],
    )
    _host, port = group.start()
    print(f"READY {port} {group.peer_id}", flush=True)

    try:
        for line in sys.stdin:
            parts = shlex.split(line)
            if not parts:
                continue
            command, rest = parts[0].upper(), parts[1:]
            try:
                if command == "EXPORT":
                    retry = float(rest[1]) if len(rest) > 1 else 1.0
                    peer_id, fingerprint = group.export_shard(
                        rest[0], retry
                    )
                    print(f"EXPORTED {peer_id} {fingerprint}", flush=True)
                elif command == "ADOPT":
                    shard_id, host, port_s, peer_s = rest
                    report = group.adopt_shard(
                        shard_id, host, int(port_s), int(peer_s)
                    )
                    print(
                        f"ADOPTED {report['sessions']} "
                        f"{report['fingerprint']}",
                        flush=True,
                    )
                elif command == "FLIP":
                    placement.complete_migration(rest[0], rest[1])
                    print("FLIPPED", flush=True)
                elif command == "RETIRE":
                    group.retire_shard(rest[0], int(rest[1]))
                    print("RETIRED", flush=True)
                elif command == "TALLY":
                    counts = group.fleet.fleet_state_counts()
                    print(
                        "TALLY "
                        + json.dumps({str(k): v for k, v in counts.items()}),
                        flush=True,
                    )
                elif command == "SLOCFG":
                    from hashgraph_tpu_torch import ScopeConfigBuilder

                    group.fleet.set_scope_config(
                        rest[0],
                        ScopeConfigBuilder()
                        .with_decide_p99_ms(float(rest[1]))
                        .build(),
                    )
                    print("SLOCFG", flush=True)
                elif command == "SLOSET":
                    from hashgraph_tpu_torch.obs import slo_engine

                    slo_engine.enabled = bool(int(rest[0]))
                    print(f"SLOSET {int(slo_engine.enabled)}", flush=True)
                else:
                    print(f"ERROR unknown command {command}", flush=True)
            except Exception as exc:  # one line per command, always
                print(f"ERROR {exc!r}", flush=True)
    finally:
        group.close()


if __name__ == "__main__":
    main()
