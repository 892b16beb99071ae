"""The port's fault plane (``horovod_tpu_torch.common.faultline``) against
the JAX package's (``horovod_tpu.common.faultline``), which imports no
JAX: one ``HVD_TPU_FAULT`` value parses to the same specs, or to the
same error, in both; ``site()`` fires the same sequence under
``@after``, ``@times`` and conditions; re-arming resets the counters in
both.  One deliberate difference: the port's ``@rank`` falls back to
``RANK`` when ``HOROVOD_RANK`` is unset.
"""

import dataclasses

import pytest

from horovod_tpu.common import faultline as ref
from horovod_tpu.common import metrics as ref_metrics
from horovod_tpu_torch.common import faultline as port
from horovod_tpu_torch.common import metrics

ENV = ("HVD_TPU_FAULT", "HOROVOD_RANK", "RANK", "HOROVOD_ELASTIC_SLOT",
       "HOROVOD_HOSTNAME", "HOROVOD_ELASTIC_EPOCH", "HOROVOD_TENANT_ID",
       "HVD_TPU_SHARD_INDEX")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    ref.reset()
    port.reset()
    yield
    ref.reset()
    port.reset()


def _parse(mod, text):
    """The specs as plain tuples, or the ValueError's text."""
    try:
        return {k: dataclasses.astuple(v) for k, v in mod.parse(text).items()}
    except ValueError as exc:
        return "ValueError: %s" % exc


SPECS = [
    # valid
    "mh.leg.drop:drop",
    "mh.leg.drop:drop@times=1",
    "mh.leg.delay:delay:0.5@after=2@times=3",
    "mh.deadline.wedge:drop@rank=1",
    "engine.cycle.pre:delay",
    "mh.enqueue.pre_register:wedge:2",
    "hvd.shutdown.pre_barrier:die:7@rank=0@epoch=3",
    "mh.leg.corrupt:drop@times=2, mh.leg.drop:drop@after=1",
    "engine.fastpath.stale_dispatch:drop@slot=0@host=127.0.0.2",
    "elastic.state.shard:drop@shard=1@tenant=a",
    " , mh.drain.record:drop ,",
    "",
    # invalid
    "mh.leg.drop",
    "mh.leg.drop:drop:1:2",
    "mh.leg.nope:drop",
    "mh.leg.drop:explode",
    "engine.cycle.pre:drop",
    "mh.leg.delay:delay:soon",
    "mh.leg.drop:drop@times=-1",
    "mh.leg.drop:drop@after=x",
    "mh.leg.drop:drop@node=1",
    "mh.leg.drop:drop@rank",
    "mh.leg.drop:drop,mh.leg.drop:delay",
]


@pytest.mark.parametrize("text", SPECS)
def test_parse_matches_the_reference(text):
    assert _parse(port, text) == _parse(ref, text)


def test_site_tables_are_the_references():
    assert port.SITES == ref.SITES
    assert port.DROP_SITES == ref.DROP_SITES
    assert port.ACTIONS == ref.ACTIONS
    with pytest.raises(KeyError):
        port.site("mh.no.such.site")


def _fires(mod, name, n=20):
    return [mod.site(name) for _ in range(n)]


@pytest.mark.parametrize("spec,env", [
    ("mh.leg.drop:drop", {}),
    ("mh.leg.drop:drop@times=3", {}),
    ("mh.leg.drop:drop@after=5", {}),
    ("mh.leg.drop:drop@after=5@times=3", {}),
    ("mh.leg.drop:drop@times=0", {}),
    ("mh.leg.drop:drop@rank=1@times=2", {"HOROVOD_RANK": "1"}),
    ("mh.leg.drop:drop@rank=1@times=2", {"HOROVOD_RANK": "0"}),
    ("mh.leg.drop:drop@epoch=2@after=1", {"HOROVOD_ELASTIC_EPOCH": "2"}),
    ("mh.leg.delay:delay:0@after=2@times=4", {}),
])
def test_fire_sequences_match_the_reference(monkeypatch, spec, env):
    """20 calls of ``site()``: the same returns, and as many fires
    counted in ``fault_injections_total``, in both packages."""
    monkeypatch.setenv("HVD_TPU_FAULT", spec)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    site = spec.split(":")[0]
    fired = [m.series_sum("fault_injections_total", site=site)
             for m in (ref_metrics, metrics)]
    assert _fires(port, site) == _fires(ref, site)
    moved = [m.series_sum("fault_injections_total", site=site) - f
             for m, f in zip((ref_metrics, metrics), fired)]
    assert moved[0] == moved[1]


def test_rearming_resets_the_counters(monkeypatch):
    for mod in (ref, port):
        monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@times=2")
        assert _fires(mod, "mh.leg.drop", 4) == [True, True, False, False]
        # Another value: a new experiment, counters from zero.
        monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@times=1")
        assert _fires(mod, "mh.leg.drop", 3) == [True, False, False]
        # The first value again: parsed anew, counted anew.
        monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@times=2")
        assert _fires(mod, "mh.leg.drop", 3) == [True, True, False]
        mod.reset()
        assert _fires(mod, "mh.leg.drop", 3) == [True, True, False]
        monkeypatch.delenv("HVD_TPU_FAULT")
        assert _fires(mod, "mh.leg.drop", 2) == [False, False]


def test_armed_does_not_fire(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@times=1")
    for mod in (ref, port):
        spec = mod.armed("mh.leg.drop")
        assert spec is not None and spec.times == 1
        assert mod.armed("mh.leg.delay") is None
        assert _fires(mod, "mh.leg.drop", 2) == [True, False]


def test_rank_falls_back_to_torch_launchers_rank(monkeypatch):
    """A deliberate difference: ``RANK`` stands in for an unset
    ``HOROVOD_RANK`` in the port; ``HOROVOD_RANK`` wins where both are
    set."""
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@rank=1")
    monkeypatch.setenv("RANK", "1")
    assert port.site("mh.leg.drop") is True
    assert ref.site("mh.leg.drop") is False
    monkeypatch.setenv("HOROVOD_RANK", "0")
    assert port.site("mh.leg.drop") is False


def test_fire_is_counted_before_the_action(monkeypatch):
    """The counter and the ``fault_fire`` event are written before the
    action runs (here a delay of 0)."""
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.delay:delay:0")
    before = metrics.series_sum("fault_injections_total",
                                site="mh.leg.delay", action="delay")
    calls = []
    monkeypatch.setattr(port.time, "sleep", lambda s: calls.append(
        metrics.series_sum("fault_injections_total", site="mh.leg.delay",
                           action="delay")))
    assert port.site("mh.leg.delay") is False
    assert calls == [before + 1]
    assert metrics.events("fault_fire")[-1]["site"] == "mh.leg.delay"
