"""The port's synthetic data pipeline against the JAX package's: tokens
and labels bit for bit for several (seed, step, shard), the
``jax.random`` pieces it reproduces on the port's threefry (key,
fold_in, split, randint, uniform) bit for bit, and the stub frontends'
bf16 normals within one bf16 ulp (the simulator's normals contract)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.data.pipeline import DataConfig as RefDC
from repro.data.pipeline import SyntheticLM as RefLM
from repro.data.pipeline import make_pipeline as ref_pipeline
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, _Key,
                                       make_pipeline)

CASES = ((0, 0, 0, 1, 64), (9, 17, 1, 2, 512), (1234, 3, 0, 1, 2048),
         (7, 1000, 3, 4, 100))


def _ref_key(seed, step, shard):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                 step), shard)


@pytest.mark.parametrize("seed,step,shard,shards,vocab", CASES)
def test_tokens_and_labels_equal_reference(seed, step, shard, shards, vocab):
    dc = dict(vocab_size=vocab, seq_len=32, global_batch=8, seed=seed)
    r = RefLM(RefDC(**dc)).batch(step, shard=shard, num_shards=shards)
    p = SyntheticLM(DataConfig(**dc)).batch(step, shard=shard,
                                            num_shards=shards)
    assert p["tokens"].dtype == torch.int64
    assert p["tokens"].shape == (8 // shards, 32)
    np.testing.assert_array_equal(p["tokens"].numpy(),
                                  np.asarray(r["tokens"]))
    np.testing.assert_array_equal(p["labels"].numpy(),
                                  np.asarray(r["labels"]))


@pytest.mark.parametrize("seed,step,shard", ((0, 0, 0), (1234, 17, 1),
                                             (2 ** 31 - 1, 5, 2)))
def test_key_streams_equal_jax_random(seed, step, shard):
    rk = _ref_key(seed, step, shard)
    pk = _Key.from_seed(seed).fold_in(step).fold_in(shard)
    assert list(pk) == np.asarray(jax.random.key_data(rk)).tolist()
    for r, p in zip(jax.random.split(rk), pk.split()):
        assert list(p) == np.asarray(jax.random.key_data(r)).tolist()
    for lo, hi in ((0, 64), (0, 4096), (5, 70001), (0, 1)):
        np.testing.assert_array_equal(
            pk.randint((3, 37), lo, hi).numpy(),
            np.asarray(jax.random.randint(rk, (3, 37), lo, hi)))
    np.testing.assert_array_equal(
        pk.uniform((5, 41)).numpy(),
        np.asarray(jax.random.uniform(rk, (5, 41))))


def test_pipeline_restart_exact_and_sharded():
    dc = DataConfig(vocab_size=512, seq_len=32, global_batch=8, seed=9)
    p1, p2 = SyntheticLM(dc), SyntheticLM(dc)
    b1, b2 = p1.batch(17), p2.batch(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    s0 = p1.batch(3, shard=0, num_shards=2)
    s1 = p1.batch(3, shard=1, num_shards=2)
    assert s0["tokens"].shape[0] == 4
    assert not torch.equal(s0["tokens"], s1["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert torch.equal(b1["tokens"][:, 0], b1["labels"][:, -1])


@pytest.mark.parametrize("arch,key", (("whisper-small", "frames"),
                                      ("llava-next-34b", "embeds")))
def test_frontends_within_one_bf16_ulp(arch, key):
    shape = ShapeConfig("t", 64, 4, "train")
    r = ref_pipeline(ref_reduced(arch), shape, seed=3).batch(5)
    p = make_pipeline(get_reduced(arch), shape, seed=3).batch(5)
    assert sorted(p) == sorted(r)
    want = np.asarray(r[key].astype(jnp.float32))
    got = p[key]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    # one bf16 ulp at each value's magnitude: 2^(exponent - 7)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_array_equal(p["labels"].numpy(),
                                  np.asarray(r["labels"]))


def test_transition_table_is_the_references():
    dc = dict(vocab_size=300, seq_len=8, global_batch=2, seed=11)
    np.testing.assert_array_equal(SyntheticLM(DataConfig(**dc)).trans.numpy(),
                                  np.asarray(RefLM(RefDC(**dc)).trans))
