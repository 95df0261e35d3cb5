"""The system under test as the drivers hold it: one
``hashgraph_tpu_torch`` engine set up from a configuration, the proposals
of a schedule as a receiving peer gets them, and what the engine answered.

Of the benchmark's modules only this one and the drivers use the program
(``run.py`` only checks that it is there).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.check import Reading
from portbench.schedule import T0, Schedule


def engine_for(config: dict, device: str, signer):
    """An engine with the configuration's settings and each scope's mode,
    and a receiver on its event bus that holds every event of a call."""
    from hashgraph_tpu_torch.engine import TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus
    from hashgraph_tpu_torch.scope_config import NetworkType, ScopeConfig

    settings = config["engine"]
    bus = BroadcastEventBus(max_queued_events=int(settings["event_queue"]))
    engine = TorchConsensusEngine(
        signer,
        capacity=int(settings["capacity"]),
        voter_capacity=int(settings["voter_capacity"]),
        event_bus=bus,
        max_sessions_per_scope=int(config["max_sessions_per_scope"]),
        device=device,
    )
    kinds = {"gossipsub": NetworkType.GOSSIPSUB, "p2p": NetworkType.P2P}
    for scope in range(int(config["scopes"])):
        mode = config["modes"][scope % len(config["modes"])]
        engine.set_scope_config(scope, ScopeConfig(
            network_type=kinds[mode],
            default_consensus_threshold=float(config["threshold"]),
            default_timeout=float(config["timeout_s"]),
            default_liveness_criteria_yes=bool(config["liveness_criteria_yes"]),
        ))
    return engine, bus.subscribe()


def proposals_of(sched: Schedule, config: dict) -> list:
    """Every proposal of the schedule as a peer would send it: no votes yet,
    round 1, its call's time, expiring ``timeout_s`` later."""
    from hashgraph_tpu_torch.wire import Proposal

    out = []
    owner = b"\x00" * 32
    for p, (scope, pid, call) in enumerate(zip(
            sched.p_scope.tolist(), sched.p_pid.tolist(), sched.p_call.tolist())):
        out.append(Proposal(
            name=f"proposal-{p}", payload=p.to_bytes(8, "little"), proposal_id=pid,
            proposal_owner=owner, votes=[], expected_voters_count=sched.n, round=1,
            timestamp=T0 + call, expiration_timestamp=T0 + call + sched.timeout_s,
            liveness_criteria_yes=bool(config["liveness_criteria_yes"]),
        ))
    return out


class Answers:
    """What the engine answered in a run: statuses of every call, the events
    taken off the bus (with when), the host blames of each call's
    signature batch, and at the end each live session's result."""

    def __init__(self, sched: Schedule):
        self.key_to_p = {
            (s, pid): p for p, (s, pid) in enumerate(zip(sched.p_scope.tolist(), sched.p_pid.tolist()))
        }
        self.proposal_statuses: "dict[int, np.ndarray]" = {}
        self.vote_statuses: "dict[int, np.ndarray]" = {}
        self.event_p: list = []
        self.event_result: list = []
        self.event_time: list = []
        self.decided = np.zeros(len(sched.p_pid), bool)
        self.latencies_s: list = []
        self.finals: "dict[int, object]" = {}
        self.blames: "dict[int, int]" = {}

    def reading(self) -> Reading:
        return Reading(self.vote_statuses, self.proposal_statuses,
                       list(zip(self.event_p, self.event_result, self.event_time)),
                       self.finals, self.blames)

    def drain(self, receiver, handed_at: "float | None" = None) -> int:
        """Take every waiting event off the bus. With ``handed_at`` (when
        the call's deciding votes were handed to the engine), a session's
        first event adds its latency."""
        key_to_p = self.key_to_p
        taken = 0
        while True:
            item = receiver.try_recv()
            if item is None:
                return taken
            now = time.perf_counter()
            scope, event = item
            p = key_to_p[(scope, event.proposal_id)]
            self.event_p.append(p)
            self.event_result.append(getattr(event, "result", None))
            self.event_time.append(event.timestamp)
            if not self.decided[p]:
                self.decided[p] = True
                if handed_at is not None:
                    self.latencies_s.append(now - handed_at)
            taken += 1

    def read_finals(self, engine) -> None:
        from hashgraph_tpu_torch.errors import ConsensusFailed

        for scope, pid in engine.session_keys():
            p = self.key_to_p[(scope, pid)]
            try:
                self.finals[p] = engine.get_consensus_result(scope, pid)
            except ConsensusFailed:
                self.finals[p] = "failed"


def signer(traffic: dict, cls=None):
    """The engine's own signer: Ed25519, verifying batches on the device
    when the traffic says so (``cls`` replaces the class, for a run on the
    CPU)."""
    from hashgraph_tpu_torch.signing.ed25519 import Ed25519ConsensusSigner

    seed = bytes(range(32))
    if cls is not None:
        return cls(seed)
    return Ed25519ConsensusSigner(seed, device_verify=bool(traffic.get("device_verify", False)))
