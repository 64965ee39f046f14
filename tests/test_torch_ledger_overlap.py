"""Port parity: ``CostLedger.overlap_io_compute``.

The same charges go to both packages' ``CostLedger``s, serialized and
with IO overlapping compute; ``snapshot()`` must agree at rtol 1e-6 (ids
and counts exactly), and the overlap mode keeps the reference's
``total == max(io, compute)`` on the sequence of
``tests/test_timeline.py``.  Every serialized charge is covered:
``miss_fill`` with and without ``prefetch``, ``flash_stream``,
``dram_read``, ``matmul``, ``ici_transfer``, ``migrate``, and the
background-lane ``prefetch_fill_at(None, ...)``, which issues at the
same serialized IO frontier.
"""

import numpy as np
import pytest

from _torch_parity import REF, PORT, assert_same

# (method, args, kwargs) in issue order: interleaved IO and compute, so
# that the two issue disciplines give different makespans.
CHARGES = [
    ("miss_fill", (2.5e6,), {}),
    ("matmul", (4, 2048, 2816, 8), {}),
    ("dram_read", (1.2e6,), {}),
    ("miss_fill", (7.5e5,), {"prefetch": True}),
    ("flash_stream", (3.1e5,), {}),
    ("matmul", (4, 1408, 2048, 4), {}),
    ("ici_transfer", (6.4e4,), {}),
    ("migrate", (4.1e6,), {}),
    ("prefetch_fill_at", (None, 9.9e5), {}),
    ("matmul", (1, 2048, 2048, 8), {}),
    ("dram_read", (2.0e5,), {}),
    ("migrate", (1.5e5,), {}),
]


def _charged(ns, overlap: bool, charges):
    led = ns.energy.CostLedger(overlap_io_compute=overlap)
    for method, args, kw in charges:
        getattr(led, method)(*args, **kw)
    return led


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serialized", "overlap"])
@pytest.mark.parametrize("n", [1, 3, len(CHARGES)])
def test_snapshot_matches_reference(overlap, n):
    ref = _charged(REF, overlap, CHARGES[:n])
    port = _charged(PORT, overlap, CHARGES[:n])
    assert port.overlap_io_compute is overlap
    assert_same(ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("method", sorted({c[0] for c in CHARGES}))
def test_each_charge_after_compute(method):
    """Each charge issued behind a matmul: with the overlap on, IO starts
    at the IO channels' frontier, not behind the compute."""
    args, kw = next((a, k) for m, a, k in CHARGES if m == method)
    lead = [("matmul", (8, 4096, 4096, 8), {})]
    for overlap in (False, True):
        ref = _charged(REF, overlap, lead + [(method, args, kw)])
        port = _charged(PORT, overlap, lead + [(method, args, kw)])
        assert_same(ref.snapshot(), port.snapshot())


def test_overlap_is_max_of_io_and_compute():
    """``tests/test_timeline.py``'s legacy-mode sequence on the port."""
    led = PORT.energy.CostLedger(overlap_io_compute=True)
    led.miss_fill(1e6)
    led.matmul(4, 1024, 1024, 8)
    led.dram_read(1e6)
    np.testing.assert_allclose(
        led.total_latency_s, max(led.io_latency_s, led.compute_latency_s),
        rtol=1e-12)
    serial = _charged(PORT, False, [("miss_fill", (1e6,), {}),
                                    ("matmul", (4, 1024, 1024, 8), {}),
                                    ("dram_read", (1e6,), {})])
    assert led.total_latency_s < serial.total_latency_s


def test_overlap_survives_clone_and_sharded_ledger_matches():
    """The field rides a clone; the sharded ledgers build their
    per-shard ledgers as the reference does (serialized)."""
    led = PORT.energy.CostLedger(overlap_io_compute=True)
    assert led.clone().overlap_io_compute is True
    ref = REF.energy.ShardedCostLedger(REF.SYSTEM_PROFILES["mobile_soc"], 3)
    port = PORT.energy.ShardedCostLedger(PORT.SYSTEM_PROFILES["mobile_soc"],
                                         3)
    assert [s.overlap_io_compute for s in port.shards] == \
        [s.overlap_io_compute for s in ref.shards]
    assert port.ici.overlap_io_compute == ref.ici.overlap_io_compute
