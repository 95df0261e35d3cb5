"""Parity: the port's process entry points (``gossip_peer``,
``federation_host`` and ``federation_scrape_smoke`` in
``examples_torch/``) against the JAX package's, as OS processes on the
CPU.

- ``gossip_peer``: a reference peer (``JAX_PLATFORMS=cpu python
  examples/gossip_peer.py``) and a twin peer (``python
  examples_torch/gossip_peer.py --device cpu``) each print ``PORT n``;
  the port's ``BridgeClient`` drives the reference peer and the JAX
  package's drives the twin, through the bridge quick-start on keyed
  peers (``chip_smoke.bridge_quickstart_answers``, phase 17's). Every
  answer is equal but the proposal id, which the server mints from the
  wall clock and random bytes (masked: events and reads are compared
  without it). Closing stdin ends both with exit 0.
- ``federation_host``: a mixed federation (h0 the reference host, h1 the
  twin) and an all-reference one take the same traffic from the port's
  ``FederationDriver`` (``chip_smoke.federation_answers``, phase 17's):
  one decision per host, one shard of h0 moved to h1 over
  ``EXPORT``/``ADOPT``/``FLIP``/``RETIRE`` (the exported and adopted
  fingerprints equal, the same session count moved in both), one more
  decision per host after the move, then ``TALLY`` on each host: the
  mixed federation's tallies equal the all-reference one's.
- ``federation_scrape_smoke``: the twin (``--device cpu``, which it
  passes on to its two ``federation_host`` twins) and the reference both
  exit 0 on the same ``federation-scrape-smoke OK`` line.

Every subprocess has its own timeout (``test_torch_examples.TIMEOUT``:
each line and each exit awaited at most that long).
Tolerance: exact.
"""

import sys
import threading

from hashgraph_tpu.bridge.client import BridgeClient as ReferenceClient

from hashgraph_tpu_torch.bridge.client import BridgeClient
from hashgraph_tpu_torch.ops.decide import STATE_REACHED_YES
from test_torch_examples import REPO, TIMEOUT, reference_env, run_both, twin_env

from chip_smoke import LineProcess, bridge_quickstart_answers, federation_answers  # noqa: E402


def host(path: str, *args: str, reference: bool = False) -> LineProcess:
    """A line-protocol program of either package, run from the repo root,
    each line awaited at most ``TIMEOUT`` s."""
    return LineProcess([sys.executable, path, *args], cwd=str(REPO), timeout=TIMEOUT,
                       env=reference_env() if reference else twin_env())


def test_gossip_peer_answers_the_other_package_client():
    ref = host("examples/gossip_peer.py", reference=True)
    twin = host("examples_torch/gossip_peer.py", "--device", "cpu")
    try:
        (ref_word, ref_port), (twin_word, twin_port) = ref.ready(), twin.ready()
        assert ref_word == twin_word == "PORT"
        ref_answers = bridge_quickstart_answers(BridgeClient, int(ref_port))
        twin_answers = bridge_quickstart_answers(ReferenceClient, int(twin_port))
    finally:
        codes = [ref.close(), twin.close()]
    assert ref_answers["results"] == [True] * 3
    assert twin_answers == ref_answers
    assert codes == [0, 0]


def federation_run(root, twin_h1: bool) -> dict:
    """``chip_smoke.federation_answers`` on two host processes, h1 the
    twin when ``twin_h1``; both must exit 0 on EOF."""
    common = ["--hosts", "h0,h1", "--shards-per-host", "2", "--capacity", "32",
              "--voter-capacity", "6"]
    hosts = {}
    for host_id in ("h0", "h1"):
        args = [*common, "--host-id", host_id, "--wal-root", str(root / host_id)]
        if twin_h1 and host_id == "h1":
            hosts[host_id] = host("examples_torch/federation_host.py", *args, "--device", "cpu")
        else:
            hosts[host_id] = host("examples/federation_host.py", *args, reference=True)
    try:
        out = federation_answers(hosts)
    finally:
        codes = [h.close() for h in hosts.values()]
    assert codes == [0, 0]
    return out


def test_federation_host_mixed_federation_migrates_and_tallies(tmp_path):
    out = {}

    def run(key, twin_h1):
        try:
            out[key] = federation_run(tmp_path / key, twin_h1)
        except BaseException as exc:  # re-raised below
            out[key] = exc

    threads = [threading.Thread(target=run, args=(k, k == "mixed")) for k in ("mixed", "reference")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * TIMEOUT)
        assert not t.is_alive()
    for value in out.values():
        if isinstance(value, BaseException):
            raise value
    mixed, reference = out["mixed"], out["reference"]
    assert mixed["fingerprints_equal"] and reference["fingerprints_equal"]
    assert mixed["sessions"] == reference["sessions"] >= 1
    assert mixed["tallies"] == reference["tallies"]
    # Two decisions before the move and two after, all YES, wherever they
    # live now.
    assert sum(t.get(str(STATE_REACHED_YES), 0) for t in mixed["tallies"].values()) == 4


def test_federation_scrape_smoke_ends_on_the_reference_ok_line(tmp_path):
    # The hosts of both smokes leave their WAL directories in TMPDIR.
    (ref_rc, ref_out, ref_err), (rc, out, err) = run_both(
        "federation_scrape_smoke", ("--device", "cpu"), tmp=tmp_path)
    assert ref_rc == 0, ref_err[-4000:]
    assert rc == 0, err[-4000:]
    assert out.splitlines() == ref_out.splitlines() == ["federation-scrape-smoke OK"]
