"""Port parity: the synthetic LM data pipeline.

``repro_torch.data.pipeline`` is a copy of the reference's numpy module;
batches, streams and host shards must equal the reference's exactly.
"""

import itertools

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDC
from repro.data.pipeline import SyntheticLM as JLM
from repro_torch.data.pipeline import DataConfig as TDC
from repro_torch.data.pipeline import SyntheticLM as TLM

CONFIGS = [
    dict(vocab_size=2048, seq_len=64, global_batch=8, seed=0),
    dict(vocab_size=512, seq_len=16, global_batch=4, seed=3, n_topics=4),
    dict(vocab_size=97, seq_len=33, global_batch=6, seed=11, zipf_a=1.1,
         topic_sharpness=2.0),
]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=["repro", "small_topics", "odd_sizes"])
def pair(request):
    return JLM(JDC(**request.param)), TLM(TDC(**request.param))


def test_generator_state_matches(pair):
    j, t = pair
    np.testing.assert_array_equal(t.base, j.base)
    np.testing.assert_array_equal(t.topic_bias, j.topic_bias)


@pytest.mark.parametrize("step, batch, seq", [(0, 2, None), (7, 3, 9),
                                              (10_000, 4, None)])
def test_sample_batch_exact(pair, step, batch, seq):
    j, t = pair
    got = t.sample_batch(step, batch, seq)
    want = j.sample_batch(step, batch, seq)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batches_exact(pair):
    j, t = pair
    for jb, tb in zip(itertools.islice(j.batches(3), 3),
                      itertools.islice(t.batches(3), 3)):
        assert tb["step"] == jb["step"]
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
        np.testing.assert_array_equal(tb["labels"], jb["labels"])


def test_host_shard_exact(pair):
    j, t = pair
    n = 2
    for idx in range(n):
        jb, tb = j.host_shard(5, idx, n), t.host_shard(5, idx, n)
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
        np.testing.assert_array_equal(tb["labels"], jb["labels"])
