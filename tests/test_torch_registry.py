"""The port's ``make_index`` takes the JAX driver's knobs with their meaning.

``insert_retries``, ``gc_lag`` and ``reassign_after_split`` are held
against the JAX driver: both packages get the same seed vectors, the
same k-means initial indices (the JAX draw, injected into the port),
the same knobs and the stream of ``tests/test_torch_driver.py``, and must
end with the same live ids and the same foreground and background
counts.  ``tier_rerank_host=False`` (the ADC-only cold read, once
refused) reaches the tier manager, ``obs_profile_dir`` captures the
first tick's trace, and the port's observability plane answers the
contract harness's ``enabled`` question, so the harness's trace audit
covers port engines.
"""
import os

import numpy as np
import pytest
import jax

from conftest import make_clustered
from contract_harness import trace_baseline
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro_torch.api import make_index
from repro_torch.core.build import initial_posting_count
from repro_torch.core.types import UBISConfig
from repro_torch.obs import Obs
from test_torch_driver import CFG, DRIVER_KW, live_ids, stream

PARITY_KEYS = ("inserted", "rejected", "bg_split", "bg_merge",
               "bg_reassigned")


def _seeds_and_init(engine):
    tcfg = UBISConfig(mode=engine, **CFG)
    seeds = make_clustered(3000, d=16, seed=3)[:800]
    k0 = initial_posting_count(tcfg, len(seeds))
    init = np.asarray(jax.random.choice(jax.random.key(0), len(seeds), (k0,),
                                        replace=False))
    return tcfg, seeds, init


def _port(engine, **kw):
    tcfg, seeds, init = _seeds_and_init(engine)
    td = make_index(engine, tcfg, seeds, device="cpu", kmeans_init=init,
                    **DRIVER_KW, **kw)
    stream(td)
    return td


# spfresh rejects the most jobs (its posting locks): the retries show there
KNOB_CASES = [("spfresh", dict(insert_retries=0, gc_lag=2)),
              ("spfresh", dict(insert_retries=4)),
              ("ubis", dict(gc_lag=4)),
              ("ubis", dict(reassign_after_split=False))]


@pytest.mark.parametrize("engine,knobs", KNOB_CASES, ids=[
    "-".join(f"{k}={v}" for k, v in kw.items()) for _, kw in KNOB_CASES])
def test_knobs_match_jax(engine, knobs):
    _, seeds, _ = _seeds_and_init(engine)
    jd = JDriver(JConfig(mode=engine, use_pallas="off", **CFG), seeds,
                 **DRIVER_KW, **knobs)
    stream(jd)
    td = _port(engine, **knobs)
    np.testing.assert_array_equal(live_ids(td.state.id_loc.numpy()),
                                  live_ids(jd.state.id_loc))
    for key in PARITY_KEYS + ("bg_gc",):
        assert td.stats[key] == jd.stats[key], (key, td.stats[key],
                                                jd.stats[key])
    if knobs.get("reassign_after_split") is False:
        assert td.stats["bg_reassigned"] == jd.stats["bg_reassigned"] == 0


def test_knobs_change_the_port_program():
    """Before the knobs were honoured, ``gc_lag`` was dropped and every
    run reclaimed on the same schedule."""
    lag2 = _port("ubis", gc_lag=2)
    lag16 = _port("ubis", gc_lag=16)
    assert lag2.stats["bg_gc"] != lag16.stats["bg_gc"], (
        lag2.stats["bg_gc"], lag16.stats["bg_gc"])


@pytest.mark.parametrize("kw", [dict(tier_rerank_host=False)])
def test_unported_knob_values_raise(kw):
    """No knob value is refused any more: ``tier_rerank_host=False`` was
    the last, and now reaches the tier manager of both drivers
    (``tests/test_torch_cluster.py`` holds its answers to the JAX
    driver's)."""
    import dataclasses
    tcfg, seeds, init = _seeds_and_init("ubis")
    tcfg = dataclasses.replace(tcfg, use_pq=True, pq_m=4, pq_ksub=16,
                               use_tier=True)
    for engine in ("ubis", "ubis-sharded"):
        td = make_index(engine, tcfg, seeds, device="cpu", kmeans_init=init,
                        **kw)
        assert td.tier.rerank_host is False


def test_obs_profile_dir_traces_the_first_tick_only(tmp_path):
    tcfg, seeds, init = _seeds_and_init("ubis")
    td = make_index("ubis", tcfg, seeds, device="cpu", kmeans_init=init,
                    obs_profile_dir=str(tmp_path), **DRIVER_KW)
    td.insert(seeds[:300], np.arange(300), tick_between=False)
    td.tick()
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json"), traces
    assert '"traceEvents"' in (tmp_path / traces[0]).read_text()
    td.tick()
    td.flush(max_ticks=5)
    assert os.listdir(tmp_path) == traces


def test_unported_knob_defaults_are_accepted():
    tcfg, seeds, init = _seeds_and_init("ubis")
    td = make_index("ubis", tcfg, seeds, device="cpu", kmeans_init=init,
                    tier_rerank_host=True, obs_profile_dir=None)
    assert td.live_count() == 0


def test_obs_enabled_feeds_the_harness_trace_audit():
    assert Obs().enabled is True
    tcfg, seeds, init = _seeds_and_init("ubis")
    td = make_index("ubis", tcfg, seeds, device="cpu", kmeans_init=init)
    base = trace_baseline(td)
    assert isinstance(base, dict), base
    assert base["tier_spilled"] == 0.0 and base["migrated"] == 0.0
