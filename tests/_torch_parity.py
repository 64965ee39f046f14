"""Shared helpers of the port's model-free parity tests (shard, placement,
control, observability): one namespace per package, so a scenario written once runs on
the reference and on the port, and a comparison that holds ids, counts and
decisions exactly and floats at rtol 1e-6."""

from types import SimpleNamespace

import numpy as np

from repro import control as JC
from repro import obs as JO
from repro import sim as JS
from repro.control import signals as JSIG
from repro.core import cache as JCA
from repro.core import placement as JP
from repro.core import shard as JSH
from repro.core import slices as JSL
from repro.core import warmup as JWU
from repro.hw import energy as JE
from repro.hw import specs as JSP
from repro.serving import telemetry as JTEL
from repro.sim import autotune as JAT
from repro.sim import trace as JT
from repro_torch import control as TC
from repro_torch import obs as TO
from repro_torch import sim as TS
from repro_torch.control import signals as TSIG
from repro_torch.core import cache as TCA
from repro_torch.core import placement as TP
from repro_torch.core import shard as TSH
from repro_torch.core import slices as TSL
from repro_torch.core import warmup as TWU
from repro_torch.hw import energy as TE
from repro_torch.hw import specs as TSP
from repro_torch.serving import telemetry as TTEL
from repro_torch.sim import autotune as TAT
from repro_torch.sim import trace as TT


def _ns(control, signals, cache, placement, shard, slices, warmup, energy,
        specs, sim, autotune, trace, obs, telemetry):
    return SimpleNamespace(
        control=control, signals=signals, cache=cache, placement=placement,
        shard=shard, SliceKey=slices.SliceKey, warmup=warmup,
        energy=energy, SYSTEM_PROFILES=specs.SYSTEM_PROFILES, sim=sim,
        autotune=autotune, trace=trace, obs=obs, telemetry=telemetry)


REF = _ns(JC, JSIG, JCA, JP, JSH, JSL, JWU, JE, JSP, JS, JAT, JT, JO, JTEL)
PORT = _ns(TC, TSIG, TCA, TP, TSH, TSL, TWU, TE, TSP, TS, TAT, TT, TO, TTEL)


def plain(x):
    """``x`` with numpy scalars/arrays, tuples and SliceKeys turned into
    plain Python lists, ints, floats and strings."""
    if isinstance(x, dict):
        return {plain(k) if not isinstance(k, str) else k: plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if hasattr(x, "_fields"):                    # SliceKey
            return [plain(v) for v in x]
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def assert_same(ref, port, path="result"):
    """Exact for everything but floats; floats at rtol 1e-6."""
    ref, port = plain(ref), plain(port)
    _same(ref, port, path)


def _same(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{path}: keys {sorted(map(str, a))} != {sorted(map(str, b))}"
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), \
            f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), f"{path}: {a!r} != {b!r}"
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0.0, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def report_view(r) -> dict:
    """The comparable part of a ``ReplayReport`` of either package."""
    return {
        "epoch_counts": r.epoch_counts,
        "per_shard_epoch_counts": r.per_shard_epoch_counts,
        "decode": [r.decode_accesses, r.decode_misses],
        "miss_curve": r.miss_curve,
        "energy_curve": r.energy_curve,
        "alpha_curve": r.alpha_curve,
        "ledger": r.ledger,
        "prefetch": r.prefetch,
        "per_tenant_rows": r.per_tenant_rows,
        "controller_summary": r.controller_summary,
        "migration_events": r.migration_events,
        "placement": r.placement,
    }


def run_both(fn):
    """``fn`` on the reference and on the port; asserts the results
    agree and returns the port's."""
    ref = fn(REF)
    port = fn(PORT)
    assert_same(ref, port)
    return port
