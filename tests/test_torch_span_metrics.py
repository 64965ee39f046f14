"""The benchmark's four readers of the program's host spans
(``portbench/metrics/{forward_wall,dispatch_host,charge_replay,
sched_host}_ms.decode.py``), on a hand-built ``Run`` and a hand-filled
recorder: each value against a hand computation, the window found by
absolute step index past records the deque has dropped, and the raise
where the recorder's steps and the run's differ."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib.bench import Run, metric_reader  # noqa: E402
from repro_torch.obs import spans as S  # noqa: E402

NAMES = ("slicemoe.decode_forward", "slicemoe.decode_charge",
         "slicemoe.decode_charge.to_host", "slicemoe.decode_charge.replay",
         "slicemoe.sched.prepare", "slicemoe.sched.sample",
         "slicemoe.sched.update")
READERS = {
    "forward_wall_ms.decode": ("slicemoe.decode_forward",
                               "slicemoe.decode_charge.to_host"),
    "dispatch_host_ms.decode": ("slicemoe.decode_forward",),
    "charge_replay_ms.decode": ("slicemoe.decode_charge.replay",),
    "sched_host_ms.decode": ("slicemoe.sched.prepare",
                             "slicemoe.sched.sample",
                             "slicemoe.sched.update"),
}


def _seconds(k, i):
    """Span ``i``'s host seconds in step ``k``: distinct in every cell."""
    return (k + 1) * 1e-3 + i * 1e-5


def _run(n_steps, d_open, d_close):
    return Run(cell=None, seconds=1.0, setup_s=1.0, t_open=0.0,
               t_close=1.0, d_open=d_open, d_close=d_close,
               step_end=[0.1 * k for k in range(n_steps)],
               wall_step_s=[0.1] * n_steps, wall_prefill_s=[],
               decodes=[None] * n_steps, prefills=[])


@pytest.fixture
def recorder(monkeypatch):
    """A recorder of 8 steps in place of the program's, filled for 12
    steps: steps 0-3 are dropped."""
    rec = S.SpanRecorder(max_steps=8)
    for k in range(12):
        rec.open_step()
        for i, n in enumerate(NAMES):
            S.add(n, _seconds(k, i))
    S.close_step()
    monkeypatch.setattr(S, "SPANS", rec)
    return rec


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_the_window_mean(recorder, metric):
    run = _run(12, d_open=5, d_close=11)
    want = sum(_seconds(k, NAMES.index(n)) for k in range(5, 11)
               for n in READERS[metric]) / 6 * 1e3
    assert metric_reader(metric)(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_slices_by_absolute_step(recorder, metric):
    # Steps 4-11 are held; a window of steps 4-5 reads the oldest two.
    run = _run(12, d_open=4, d_close=6)
    want = sum(_seconds(k, NAMES.index(n)) for k in (4, 5)
               for n in READERS[metric]) / 2 * 1e3
    assert metric_reader(metric)(run) == pytest.approx(want, rel=1e-12)
    # A window reaching into the dropped steps raises.
    with pytest.raises(IndexError):
        metric_reader(metric)(_run(12, d_open=3, d_close=6))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_raises_on_a_step_count_mismatch(recorder, metric):
    for n_steps in (11, 13):
        with pytest.raises(RuntimeError, match="span recorder"):
            metric_reader(metric)(_run(n_steps, d_open=5, d_close=10))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_raises_where_a_window_step_lacks_a_span(recorder, metric):
    recorder.open_step()                # step 12: recorded nothing
    S.close_step()
    with pytest.raises(KeyError):
        metric_reader(metric)(_run(13, d_open=10, d_close=13))


def test_forward_wall_holds_the_dispatch(recorder):
    run = _run(12, d_open=5, d_close=11)
    assert metric_reader("dispatch_host_ms.decode")(run) \
        < metric_reader("forward_wall_ms.decode")(run)
