"""Port parity: the cost-model profiles of ``repro_torch.hw.specs``.

``TPU_OFFLOAD`` is the reference's ``tpu_offload`` profile, copied for
replay parity: it must equal the reference's field by field, and a trace
replayed under it must give the reference's report.  ``MOBILE_SOC`` is
held the same way, so that ``SYSTEM_PROFILES`` is one table in both
packages.
"""

import dataclasses
import pathlib

import pytest

from _torch_parity import assert_same, report_view
from repro.hw import specs as JSP
from repro.sim import Trace as JTrace
from repro.sim import replay_trace as jreplay
from repro_torch.core.engine import EngineConfig
from repro_torch.hw import specs as TSP
from repro_torch.sim import Trace as TTrace
from repro_torch.sim import replay_trace as treplay

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_trace.npz"


@pytest.mark.parametrize("name", ["mobile_soc", "tpu_offload"])
def test_profile_equals_reference_field_by_field(name):
    ref, port = JSP.SYSTEM_PROFILES[name], TSP.SYSTEM_PROFILES[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.miss_penalty_ratio_bw == ref.miss_penalty_ratio_bw
    assert port.miss_penalty_ratio_energy == ref.miss_penalty_ratio_energy


def test_profile_tables_name_the_same_systems():
    assert list(TSP.SYSTEM_PROFILES) == list(JSP.SYSTEM_PROFILES)
    assert TSP.SYSTEM_PROFILES["tpu_offload"] is TSP.TPU_OFFLOAD
    assert EngineConfig(system="tpu_offload").ledger().system \
        is TSP.TPU_OFFLOAD


@pytest.mark.parametrize("over", [
    dict(system="tpu_offload"),
    dict(system="tpu_offload", async_io=True, prefetch_top_m=4),
    dict(system="tpu_offload", ep_shards=2),
], ids=["serial", "async_prefetch", "ep2"])
def test_replay_under_tpu_offload_equals_reference(over):
    ref = jreplay(JTrace.load(str(GOLDEN)), **over)
    port = treplay(TTrace.load(str(GOLDEN)), **over)
    assert_same(report_view(ref), report_view(port))
    mobile = treplay(TTrace.load(str(GOLDEN)),
                     **dict(over, system="mobile_soc"))
    assert port.total_energy_j != mobile.total_energy_j
