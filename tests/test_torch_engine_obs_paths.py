"""Observability parity on the paths of the later slices: the wire path,
proposals from peers and the session tier, through
``test_torch_engine_obs.py``'s machinery (the traces, what is compared and
what is masked are listed there). The JAX engine runs in a subprocess
(``python tests/test_torch_engine_obs.py --reference paths``).
"""

import pytest
import test_torch_engine_obs as EO


@pytest.fixture(scope="module")
def reference():
    return EO.reference_group("paths")


@pytest.fixture(scope="module")
def port():
    return EO.port_group("paths")


@pytest.mark.parametrize("key", EO.GROUPS["paths"])
def test_observability_matches_reference(reference, port, key):
    EO.assert_matches(reference, port, key)


def test_traces_exercise_the_hooks(port):
    """The traces reach the later slices' hooks: wire dispatches, the
    verify cache, watermark extensions, fork evidence, host spills, the
    tier's traffic and its lifecycle note."""
    EO.exercised(port, ("hashgraph_bridge_wire_device_dispatches_total",
                        "hashgraph_verify_cache_hits_total", "hashgraph_tier_demotions_total",
                        "hashgraph_tier_promotions_total", "hashgraph_tier_gc_total",
                        "hashgraph_timeouts_fired_total"),
                 ("engine.chain_extensions", '["kind", "fork"]', "engine.host_spills",
                  "engine.lifecycle_sweep", "engine.dangling_votes_rejected"))
    assert sum(o["histograms"]["hashgraph_chain_suffix_length"]["count"]
               for o in port.values()) > 0
