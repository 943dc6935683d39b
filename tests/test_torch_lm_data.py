"""The port's LM data pipeline (``repro_torch.data.pipeline``): the
reference's pipeline tests run on the port, and the same ``(seed, step,
shard)`` gives the reference's arrays bit for bit."""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.data import pipeline as jpipeline
from repro_torch.data import pipeline


def test_deterministic():
    cfg = pipeline.DataConfig(global_batch=4, seq_len=16, vocab_size=100)
    a = pipeline.make_batch(cfg, 7)
    b = pipeline.make_batch(cfg, 7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_steps_differ():
    cfg = pipeline.DataConfig(global_batch=4, seq_len=16, vocab_size=100)
    a = pipeline.make_batch(cfg, 1)["tokens"]
    b = pipeline.make_batch(cfg, 2)["tokens"]
    assert not np.array_equal(a, b)


def test_shards_differ():
    cfg = pipeline.DataConfig(global_batch=8, seq_len=16, vocab_size=100,
                              num_shards=2)
    a = pipeline.make_batch(cfg, 0, shard=0)["tokens"]
    b = pipeline.make_batch(cfg, 0, shard=1)["tokens"]
    assert a.shape == (4, 16)
    assert not np.array_equal(a, b)


def test_iterator_skip_ahead():
    cfg = pipeline.DataConfig(global_batch=2, seq_len=8, vocab_size=50)
    it = pipeline.batch_iterator(cfg, start_step=3)
    first = next(it)
    np.testing.assert_array_equal(first["tokens"],
                                  pipeline.make_batch(cfg, 3)["tokens"])


@settings(max_examples=10, deadline=None)
@given(vocab=st.integers(10, 1000), step=st.integers(0, 1000))
def test_tokens_in_range(vocab, step):
    cfg = pipeline.DataConfig(global_batch=2, seq_len=32, vocab_size=vocab)
    t = pipeline.make_batch(cfg, step)["tokens"]
    assert t.min() >= 0 and t.max() < vocab


def test_audio_batch():
    cfg = pipeline.DataConfig(global_batch=2, seq_len=16, vocab_size=30,
                              frontend="audio", frontend_dim=8)
    b = pipeline.make_batch(cfg, 0)
    assert b["frames"].shape == (2, 16, 8)
    assert b["labels"].shape == (2, 16)


def test_vision_batch():
    cfg = pipeline.DataConfig(global_batch=2, seq_len=24, vocab_size=30,
                              frontend="vision", frontend_dim=8, num_patches=8)
    b = pipeline.make_batch(cfg, 0)
    assert b["tokens"].shape == (2, 16)
    assert b["patches"].shape == (2, 8, 8)


@pytest.mark.parametrize("fields,step,shard", [
    (dict(seed=0, global_batch=8, seq_len=128, vocab_size=151936), 0, 0),
    (dict(seed=3, global_batch=8, seq_len=16, vocab_size=100,
          num_shards=2), 5, 1),
    (dict(global_batch=2, seq_len=16, vocab_size=30, frontend="audio",
          frontend_dim=8), 2, 0),
    (dict(global_batch=2, seq_len=24, vocab_size=30, frontend="vision",
          frontend_dim=8, num_patches=8), 9, 0),
], ids=["lm", "sharded", "audio", "vision"])
def test_batches_bit_equal_to_reference(fields, step, shard):
    got = pipeline.make_batch(pipeline.DataConfig(**fields), step, shard)
    want = jpipeline.make_batch(jpipeline.DataConfig(**fields), step, shard)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert [f.name for f in dataclasses.fields(pipeline.DataConfig)] == \
        [f.name for f in dataclasses.fields(jpipeline.DataConfig)]
