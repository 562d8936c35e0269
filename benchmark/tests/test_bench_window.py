"""The window arithmetic: a rate over all the work and all the time of the
window, and a reservoir of sampled calls drawn from the seed."""

import time

import pytest
import torch

from benchmark.drivers import perceive


class FakeState:
    calls = 0
    kept = []


def _fake_call(delay):
    def call(st):
        time.sleep(delay)
        st.calls += 1
        t = torch.full((1,), float(st.calls))
        return st.calls - 1, t, t, t
    return call


def test_rate_counts_every_frame_over_the_whole_window(monkeypatch, small_ctx):
    monkeypatch.setattr(perceive, "call", _fake_call(0.01))
    ctx = small_ctx("perceive_int8_b64")
    st = FakeState()
    st.kept = []
    w = perceive.window(ctx, st, 0.2)
    assert w.seconds >= 0.2
    assert w.units == st.calls and w.attempted == st.calls * ctx.sizes["batch"]
    assert w.metrics["two_view_fps"] == pytest.approx(w.attempted / w.seconds)
    # ~10 ms a call: the last call ends the window, none is left out
    assert w.metrics["two_view_fps"] == pytest.approx(ctx.sizes["batch"] / 0.01, rel=0.3)


def test_reservoir_is_drawn_from_the_seed(monkeypatch, small_ctx):
    monkeypatch.setattr(perceive, "call", _fake_call(0.0005))
    picks = []
    for seed in (11, 11, 12):
        st = FakeState()
        st.kept = []
        perceive.window(small_ctx("perceive_int8_b64", seed=seed), st, 0.1)
        picks.append(sorted(int(k[1]) for k in st.kept))
    assert len(picks[0]) == 2
    # the same seed draws the same positions where the windows are as long
    n = min(len(picks[0]), len(picks[1]))
    assert n == 2
    assert max(picks[0] + picks[1] + picks[2]) > 2    # not only the first calls


def test_p95_from_due_times_counts_unanswered_frames_as_infinitely_late():
    from benchmark.drivers import serve

    due = {f: 10.0 + 0.05 * f for f in range(100)}
    arrived = {(d, f): (due[f] + 0.01 * (f % 10 + 1) + 0.001 * d, None)
               for d in (0, 1) for f in range(100)}
    lat = serve.latencies(due, arrived)
    assert lat[3] == pytest.approx(0.041)              # the later of the two drones
    assert serve.p95(lat) == pytest.approx(0.101)      # nearest rank: the 95th of 100
    for f in range(5):                                 # 5 frames one drone never answered
        del arrived[(f % 2, f)]
    lat = serve.latencies(due, arrived)
    assert sum(x == float("inf") for x in lat) == 5
    assert serve.p95(lat) == pytest.approx(0.101)
    del arrived[(0, 50)]                               # a sixth: the 95th is now unanswered
    assert serve.p95(serve.latencies(due, arrived)) == float("inf")
