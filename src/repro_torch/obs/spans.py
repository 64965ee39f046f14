"""Wall-clock spans of the serving path, on the host clock.

``with span(name):`` adds the block's host seconds (``time.perf_counter``)
to the open step record under ``name``; a span that runs twice in one
step (two prefills) adds both.  While a ``torch.profiler`` is active it
also opens ``torch.profiler.record_function(name)``, so that the span is
a range on the same clock as the device trace and each idle gap of the
device can be put down to the host work around it.  With no profiler
active it opens no range: the record alone is two clock reads and one
dict update.

Records belong to a :class:`SpanRecorder`.  A
``ContinuousBatchingScheduler`` claims one when it is built
(``self.spans = SPANS.claim(self)``): the process-wide :data:`SPANS`,
cleared, where no other live scheduler holds it, else a recorder of its
own, so two schedulers in one process (a live one and one that records
a trace) never write into or clear each other's records.  Each
``step()`` opens one record first and closes it when it returns, so
record *k* holds the spans of that scheduler's step *k*: its admissions
and prefills, then its decode step.  Spans that run while no step is
open (an engine driven without a scheduler, the trace replay) are
ranges only.  Records live in a deque of ``MAX_STEPS``; each keeps its
absolute index, so ``recorder.step(k)`` reads step *k* as long as it is
among the last ``MAX_STEPS``.

The spans and their nesting, in the order a scheduler step runs them::

    slicemoe.prefill_forward           run_prefill: the model's prefill
    slicemoe.prefill_charge            its routing to the host, the charge
    slicemoe.sched.prepare             the token and slot-mask arrays
    slicemoe.decode_forward            decode_batch: the forward's launches
        slicemoe.decode_forward.mla        each MLA layer's launches (only
                                           configurations with MLA)
    slicemoe.decode_charge             the charge path, which holds
        slicemoe.decode_charge.to_host     the wait for the forward and the
                                           routing trace's copy to the host
        slicemoe.decode_charge.replay      the slice cache and ledger replay
    slicemoe.sched.sample              argmax of the logits, its copy to the
                                       host, the synchronize
    slicemoe.sched.update              the simulated clock, telemetry, the
                                       per-sequence loop with retirement

A span is host work only: it adds no synchronize, no ``.item()``, no
CUDA event and no device work.  What it times is the host's wall between
its two clock reads, which includes any wait for the device made by the
code inside it (``to_host`` and ``sample`` hold such waits).  See
docs/torch_spans.md.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Dict, Optional

import torch
from torch.profiler import record_function

MAX_STEPS = 65536

# The step record spans add to; None while no step is open.
_open: Optional[Dict[str, float]] = None


class SpanRecorder:
    """Per-step host seconds of each span name, in a deque of
    ``max_steps`` records addressed by absolute step index."""

    def __init__(self, max_steps: int = MAX_STEPS):
        self._records: collections.deque = collections.deque(
            maxlen=max_steps)
        self._dropped = 0               # absolute index of _records[0]
        self._owner: Optional[weakref.ref] = None

    def claim(self, owner) -> "SpanRecorder":
        """The recorder for ``owner``'s steps: this one, cleared, unless
        another live owner holds it; then a new one of the same bound."""
        held = self._owner() if self._owner is not None else None
        if held is not None and held is not owner:
            return SpanRecorder(self._records.maxlen).claim(owner)
        self.reset()
        self._owner = weakref.ref(owner)
        return self

    def reset(self) -> None:
        """Forget every record."""
        self._records.clear()
        self._dropped = 0

    def open_step(self) -> int:
        """Begin a new step record, which spans add to until
        :func:`close_step`; returns its absolute index."""
        global _open
        if len(self._records) == self._records.maxlen:
            self._dropped += 1
        _open = {}
        self._records.append(_open)
        return self.n_steps - 1

    @property
    def n_steps(self) -> int:
        """Steps opened since the last :meth:`reset`, dropped ones too."""
        return self._dropped + len(self._records)

    def step(self, k: int) -> Dict[str, float]:
        """Record of absolute step ``k``: span name -> host seconds."""
        i = k - self._dropped
        if not 0 <= i < len(self._records):
            raise IndexError(f"step {k} is not held (steps "
                             f"{self._dropped}..{self.n_steps - 1})")
        return self._records[i]


SPANS = SpanRecorder()


def close_step() -> None:
    """End the open step record; spans go unrecorded until the next
    :meth:`SpanRecorder.open_step`."""
    global _open
    _open = None


def add(name: str, seconds: float) -> None:
    """Add ``seconds`` under ``name`` to the open step record, if any."""
    rec = _open
    if rec is not None:
        rec[name] = rec.get(name, 0.0) + seconds


class span:
    """Context manager: host seconds of the block under ``name`` in the
    open step record, and a ``record_function`` range named ``name``
    while a profiler is active."""

    __slots__ = ("_name", "_range", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._range = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        add(self._name, time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False
