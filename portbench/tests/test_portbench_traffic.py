"""The traffic generator: a seed gives the same stream, strata hold."""

import json

import numpy as np
import pytest

from portbench.lib.traffic import LengthDist, Mix, Stream
from portbench.tests.cells import HERE

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def _mix(name):
    with open(HERE / "traffic" / f"{name}.json") as f:
        return Mix.from_json(json.load(f))


@pytest.mark.parametrize("name", MIXES)
def test_stream_repeats_for_a_seed(name):
    mix = _mix(name)
    a = Stream(mix, 2 ** 31 + 5, 1000)
    b = Stream(mix, 2 ** 31 + 5, 1000)
    order = [7, 0, 3, 130, 64]
    for i in order:                       # asked in another order
        pa, oa = a.request(i)
        pb, ob = b.request(i)
        assert oa == ob and np.array_equal(pa, pb)
    c = Stream(mix, 2 ** 31 + 6, 1000)
    assert any(not np.array_equal(a.request(i)[0], c.request(i)[0])
               for i in order)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_bounds_and_stratified(name):
    mix = _mix(name)
    s = Stream(mix, 12345, 1000)
    n = mix.strata
    lens = np.array([s.lengths(i) for i in range(4 * n)])
    assert lens[:, 0].min() >= mix.prompt.min_len
    assert lens[:, 0].max() <= mix.prompt.top
    assert lens[mix.clients:, 1].max() <= mix.output.top
    first = lens[:mix.clients, 1]
    assert first.min() >= 1 and first.max() <= mix.output.top
    # Each block holds one draw from each stratum of the distribution.
    for b in range(1, 4):
        block = np.sort(lens[b * n:(b + 1) * n, 0])
        edges = [mix.prompt.quantile(j / n + 1e-12) for j in range(n)]
        assert np.all(block >= np.array(edges))


def test_lognormal_quantile_clips_both_ends():
    d = LengthDist("lognormal", 256, sigma=0.5, min_len=64, max_len=512)
    assert d.quantile(1e-9) == 64
    assert d.quantile(1 - 1e-9) == 512
    assert d.quantile(0.5) == 256
    u = np.linspace(1e-6, 1 - 1e-6, 2001)
    lens = [d.quantile(float(x)) for x in u]
    assert lens == sorted(lens)
    assert min(lens) == 64 and max(lens) == 512
