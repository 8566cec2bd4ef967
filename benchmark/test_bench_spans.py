"""The readings of the program's spans (benchmark/spans.py): each on a
hand-built run and its silence without spans, the breakdown from the
span tree and the window's gaps, and the harness's own runs, which
record no spans, left as they are."""
import types

import pytest

from benchmark import harness, spans
from benchmark.test_bench_harness import _small_spec

READINGS = (spans.kernel1_us_per_iter, spans.iterate_block_us_per_iter,
            spans.phase_loop_us_per_iter, spans.outside_checks_ms,
            spans.host_us_per_call, spans.idle_gaps)
ROOT = "solve_batch_shared"


def _device():
    def t(ns, count):
        return dict(ns=int(ns), count=count)
    return {ROOT: t(100e6, 2),
            ROOT + "/phase1": t(80e6, 2),
            ROOT + "/phase1/checks": t(70e6, 2),
            ROOT + "/phase1/checks/check": t(65e6, 20),
            ROOT + "/phase1/checks/check/kernel1": t(50e6, 20),
            ROOT + "/fallback": t(12e6, 1),
            ROOT + "/fallback/checks": t(10e6, 1),
            ROOT + "/fallback/checks/check": t(9e6, 4),
            ROOT + "/fallback/checks/check/iterate_block": t(8e6, 4)}


def _call(call, t0, launch=(150, 50)):
    """The host spans of one call of the entry starting at t0: its top
    span 250 ns long, 'inputs' and a 'launch'."""
    a, d = launch
    return [dict(name="inputs", parent=ROOT, path=ROOT + "/inputs",
                 depth=1, start=t0 + 10, end=t0 + 50, call=call),
            dict(name="launch", parent=ROOT, path=ROOT + "/launch",
                 depth=1, start=t0 + a, end=t0 + a + d, call=call),
            dict(name=ROOT, parent=None, path=ROOT, depth=0, start=t0,
                 end=t0 + 250, call=call)]


def _run(**kw):
    """Two window calls (call ids 2 and 3) after a warm call (1): each
    call's bounds, entry spans and replay on one timeline (ns)."""
    cell = types.SimpleNamespace(
        config={"settings": {"eps_abs": 1e-6, "eps_rel": 1e-6}},
        traffic={"entry": ROOT})
    warm = [dict(name=ROOT, parent=None, path=ROOT, depth=0,
                 start=-5000, end=-3000, call=1)]
    traced = dict(spans=warm + _call(2, 150) + _call(3, 1150),
                  device=_device(), host={},
                  replays=[dict(seq=0, path=ROOT, start=380, end=900),
                           dict(seq=1, path=ROOT, start=1380, end=1900)],
                  clock={"cuda:0": dict(offset_ns=0.0, drift=1.0,
                                        uncertainty_ns=5.0)})
    run = types.SimpleNamespace(
        cell=cell, calls_ms=[1.0, 1.0], window_s=2e-6, spans=traced,
        bounds_ns=[(-6000, -5900), (0, 100), (1000, 1100)])
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_each_reader_on_a_hand_built_run():
    run = _run()
    assert spans.kernel1_us_per_iter(run) == \
        pytest.approx(50e6 / 1e3 / (20 * 25))
    assert spans.iterate_block_us_per_iter(run) == \
        pytest.approx(8e6 / 1e3 / (4 * 25))
    assert spans.phase_loop_us_per_iter(run) == \
        pytest.approx((80e6 - 50e6 - 8e6) / 1e3 / (24 * 25))
    assert spans.outside_checks_ms(run) == \
        pytest.approx((100e6 - 80e6) / 1e6 / 2)
    # 150 ns from a call's start to its launch; the warm call left out.
    assert spans.host_us_per_call(run) == pytest.approx(0.15)


def test_host_time_stops_at_the_first_launch():
    """Host work after the launch overlaps the replay and is not read;
    a call that launched nothing is left out."""
    run = _run()
    run.spans["spans"] = (_call(2, 150, launch=(40, 200))
                          + [sp for sp in _call(3, 1150)
                             if sp["name"] != "launch"])
    assert spans.host_us_per_call(run) == pytest.approx(0.04)


@pytest.mark.parametrize("spans_read", [
    None,
    dict(spans=[], device={}, host={"solve_batch_shared": dict(ns=1,
                                                                count=1)},
         replays=[], clock={})], ids=["no_trace", "no_replay"])
def test_each_reader_is_silent_without_the_programs_spans(spans_read):
    run = _run(spans=spans_read)
    for reading in READINGS:
        assert reading(run) is None, reading.__name__
    bare = types.SimpleNamespace(cell=run.cell, calls_ms=[1.0])
    for reading in READINGS:
        assert reading(bare) is None, reading.__name__


def test_device_ops_are_the_trees_self_times():
    ops = dict(spans.device_ops(_device(), top=20))
    assert ops[ROOT] == pytest.approx((100e6 - 80e6 - 12e6) / 1e9)
    assert ops[ROOT + "/phase1/checks/check"] == pytest.approx(15e6 / 1e9)
    assert ops[ROOT + "/phase1/checks"] == pytest.approx(5e6 / 1e9)
    assert sum(ops.values()) == pytest.approx(100e6 / 1e9)
    assert list(ops)[0] == ROOT + "/phase1/checks/check/kernel1"


def test_idle_gaps_name_each_gap_by_its_innermost_span():
    """Gaps [0, 380), [900, 1380), [1900, 2000) ns: the bounds, the
    top span, its 'inputs' and 'launch', and what no span covers."""
    gaps = dict(spans.idle_gaps(_run()))
    assert gaps == pytest.approx({
        spans.BOUNDS: 200e-9, spans.NO_SPAN: 300e-9,
        "host: " + ROOT: 280e-9, "host: " + ROOT + "/inputs": 80e-9,
        "host: " + ROOT + "/launch": 100e-9})
    busy = (900 - 380) + (1900 - 1380)
    assert sum(gaps.values()) == pytest.approx((2000 - busy) * 1e-9)


def test_the_harness_runs_as_it_did(tmp_path):
    """Importing the readings changes nothing of the harness: a traced
    CPU run records no spans, its breakdown is the harness's own, and
    the port's tracing stays off."""
    from admm_library_torch.utils import trace
    run_cls, breakdown = harness.Run, harness._breakdown
    base, spec = _small_spec(tmp_path)
    result, rec = harness.run("rdv.replan", 2**31 + 5, 0.2, True,
                              device="cpu", spec=spec, base=base,
                              log=lambda *a: None)
    assert harness.Run is run_cls and harness._breakdown is breakdown
    assert type(rec) is harness.Run and not hasattr(rec, "spans")
    assert not trace.enabled()
    assert {name for name, _ in result["breakdown"]["idle_gaps"]} == {
        "host inside calls, outside replays",
        "host between calls: bounds of the next call",
        "host between calls: bookkeeping"}
    for reading in READINGS:
        assert reading(rec) is None, reading.__name__
