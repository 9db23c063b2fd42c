"""The readers of the program's own trace (``harness/spans.py`` and the
per-layer metrics that use it) on a made-up ``trace.summary()``: device ms
and counters over the rounds or calls recorded, and nothing (None) where
the program keeps no trace, recorded no round or call, or none of the
spans read."""
from __future__ import annotations

import sys

import pytest

from bench.harness import manifest, spans


def made_up(rounds=2, calls=2):
    span = lambda ms: {"calls": 4, "host_s": 0.5, "self_s": 0.25, "device_ms": ms}
    return {"spans": {"repro.lora.backward": span(300.0), "repro.attention.backward": span(80.0),
                      "repro.moe.dispatch": span(10.0), "repro.moe.combine": span(20.0),
                      "repro.moe.dispatch.backward": span(30.0),
                      "repro.moe.combine.backward": span(40.0),
                      "repro.rpca.svt_exact": span(4400.0)},
            "counters": {"host_syncs": 216, "sync.eigh": 100},
            "rounds": rounds, "calls": calls, "dropped": 0}


WANT = {"lora_bwd_ms.round": 150.0, "lora_bwd_ms.round.moe": 150.0, "attn_bwd_ms.round": 40.0,
        "moe_dispatch_ms.round.moe": 50.0, "host_syncs.round": 108.0,
        "host_syncs.round.moe": 108.0, "host_syncs.agg": 108.0, "svt_exact_ms.agg": 2200.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_normalise_by_rounds_or_calls(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: made_up())
    assert manifest.metric_reader(name)({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_give_none_without_a_round_or_call(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: made_up(rounds=0, calls=0))
    assert manifest.metric_reader(name)({}) is None


def test_missing_spans_and_missing_events_give_none():
    s = made_up()
    assert spans.device_ms(["repro.nothing"], "rounds", s) is None
    s["spans"]["repro.lora.backward"]["device_ms"] = None  # recorded without CUDA
    assert spans.device_ms(["repro.lora.backward"], "rounds", s) is None
    assert spans.counter("sync.svt_route", "calls", s) == 0.0


def test_a_program_without_the_trace_module_gives_none(monkeypatch):
    import repro_torch.utils

    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)  # import raises
    monkeypatch.delattr(repro_torch.utils, "trace", raising=False)
    assert spans.summary() is None
    for name in WANT:
        assert manifest.metric_reader(name)({}) is None
