"""The readers of the program's spans (``benchmark/spans.py`` and the six
metrics of source ``program_span`` that read it) on synthetic records:
each returns the value worked out by hand from a device-only session's
records and spans, and a later session (60 s later, and for the eval
0.75 s later, as on the card), with longer host spans, changes none of
them; a program without spans gives no reading, and the tiny cells'
traced runs on the CPU (no profile) report none."""
from __future__ import annotations

import pytest

from benchmark import harness, trace
from benchmark.tests import tiny
from gennbv_tpu_torch.utils import profiling

T = 1_700_000_000_000_000_000            # a Unix-epoch instant, ns
MS, S = 1_000_000, 1_000_000_000
EVAL = ("env_step_host_ms.eval", "policy_host_ms.eval",
        "env_step_idle_share.eval")
TRAIN = ("rollout_host_s.train", "update_host_s.train",
         "rollout_idle_share.train")


def _span(name, unit, start, end):
    return profiling.Span(0, name, None, unit, T + start, T + end)


def _eval_rec():
    """Two episodes in a 100 ms window: the device busy 0-10, 30-40 and
    60-100 ms (idle 10-30 and 40-60); env steps of 30 and 20 ms, the
    first 20 ms idle inside, the second 10; forwards of 2 and 4 ms."""
    device = [trace.Span("k", T, T + 10 * MS),
              trace.Span("k", T + 30 * MS, T + 40 * MS),
              trace.Span("k", T + 60 * MS, T + 100 * MS)]
    spans = [_span("eval/episode", 1, 0, 50 * MS),
             _span("env/step", 1, 5 * MS, 35 * MS),
             _span("policy/forward", 1, 36 * MS, 38 * MS),
             _span("eval/episode", 2, 50 * MS, 100 * MS),
             _span("env/step", 2, 50 * MS, 70 * MS),
             _span("policy/forward", 2, 71 * MS, 75 * MS),
             _span("env/step", None, 0, 100 * MS)]    # of no unit: ignored
    later = [_span("eval/episode", 3, 60 * S, 61 * S),
             _span("env/step", 3, 60 * S, 60 * S + 500 * MS),
             _span("policy/forward", 3, 60 * S + 500 * MS, 60 * S + 600 * MS),
             # the host-records session as it follows on the card
             _span("eval/episode", 4, 850 * MS, 1050 * MS),
             _span("env/step", 4, 900 * MS, 1000 * MS),
             _span("policy/forward", 4, 1000 * MS, 1040 * MS)]
    return {"spans": device, "window_ns": 100 * MS}, spans, later


def _train_rec():
    """The cut window of 5 s, the device idle 2-3 s; three iterations
    around it (rollouts of 1.0, 1.3 and 1.1 s, updates of 3, 2 and 3 s),
    the second's rollout idle 0.8 s of the window."""
    device = [trace.Span("k", T, T + 2 * S), trace.Span("k", T + 3 * S,
                                                        T + 5 * S)]
    spans = [_span("runner/dispatch", 1, -5 * S, -1 * S),
             _span("rollout", 1, -5 * S, -4 * S),
             _span("update", 1, -4 * S, -1 * S),
             _span("rollout", 2, 1500 * MS, 2800 * MS),
             _span("update", 2, 2800 * MS, 4800 * MS),
             _span("rollout", 3, 5500 * MS, 6600 * MS),
             _span("update", 3, 6600 * MS, 9600 * MS),
             _span("runner/process", 3, 12 * S, 13 * S)]
    later = [_span("rollout", 4, 60 * S, 65 * S),
             _span("update", 4, 65 * S, 65 * S + 500 * MS),
             _span("rollout", 5, 70 * S, 75 * S),
             _span("update", 5, 75 * S, 75 * S + 500 * MS)]
    return {"spans": device, "window_ns": 5 * S}, spans, later


WANT = {"env_step_host_ms.eval": 25.0, "policy_host_ms.eval": 3.0,
        "env_step_idle_share.eval": 30.0, "rollout_host_s.train": 1.1,
        "update_host_s.train": 3.0, "rollout_idle_share.train": 16.0}


@pytest.mark.parametrize("later", [False, True])
@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_reader_reads_the_device_only_session(monkeypatch, name, later):
    rec, spans, second = (_eval_rec() if name in EVAL else _train_rec())
    monkeypatch.setattr(profiling, "spans",
                        lambda: spans + (second if later else []))
    got = harness.metric_reader(name).read(rec)
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_reader_gives_nothing_without_spans_or_records(monkeypatch, name):
    rec, spans, _ = (_eval_rec() if name in EVAL else _train_rec())
    reader = harness.metric_reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert reader.read({}) is None
    # a program that predates the tracer
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(rec) is None


def test_idle_share_of_a_layer_is_at_most_the_whole():
    rec = _eval_rec()[0]
    whole = harness.metric_reader("idle_share.eval").read(rec)
    assert whole == pytest.approx(40.0)
    assert WANT["env_step_idle_share.eval"] <= whole


@pytest.mark.parametrize("workload", ["flagship128.train", "ref400.eval"])
def test_tiny_traced_run_reports_no_span_metric(workload):
    res = tiny.run_tiny(workload, traced=True)
    assert res["correct"]
    assert not set(res["metrics"]) & set(EVAL + TRAIN)
