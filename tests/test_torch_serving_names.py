"""Port parity: ``repro_torch.serving`` exports the reference's public
names (``src/repro/serving/__init__.py``): the same ``__all__``, every
name resolving to the port's own object in its submodule."""

import importlib

import pytest

import repro.serving as JSV
import repro_torch.serving as TSV

HOMES = {
    "Completion": "scheduler", "ContinuousBatchingScheduler": "scheduler",
    "Request": "scheduler", "SchedulerConfig": "scheduler",
    "PlainEngine": "server", "SliceMoEServer": "server",
    "FleetTelemetry": "telemetry", "percentile": "telemetry",
    "LengthDist": "workloads", "TenantSpec": "workloads",
    "TimedRequest": "workloads", "WorkloadConfig": "workloads",
    "generate": "workloads", "scenario": "workloads",
}


def test_all_lists_are_equal():
    assert list(TSV.__all__) == list(JSV.__all__)
    assert sorted(HOMES) == sorted(JSV.__all__)


@pytest.mark.parametrize("name", sorted(HOMES))
def test_name_resolves_to_the_ports_submodule(name):
    home = importlib.import_module(f"repro_torch.serving.{HOMES[name]}")
    assert getattr(TSV, name) is getattr(home, name)
    assert getattr(TSV, name).__module__.startswith("repro_torch.")


def test_import_from_the_package():
    from repro_torch.serving import SliceMoEServer
    from repro_torch.serving.server import SliceMoEServer as direct

    assert SliceMoEServer is direct
