"""The port's sharding layer on several ranks: gloo process groups on the
CPU, each rank a process of its own (``torch_dist_ranks.py``), each
spawn given its own time limit so that a hung rendezvous fails its test.
No process group is brought up in the test process; a run of one rank
(the launcher without ``torchrun``) needs none.

- ``compressed_allreduce`` and ``make_compressed_grad_fn`` on 4 ranks
  against the reference's on a 4-device host mesh (a subprocess with
  ``--xla_force_host_platform_device_count=4``), the same inputs. The
  reduction: within 2^-22 relative (two f32 ulps; XLA rounds the
  scales' division by 127 otherwise than torch, about half the values
  differ by one ulp, none by an int8 step). The gradients: within one
  int8 step of their block (the largest |value| / 127), as the two
  packages' f32 products round otherwise and a requantised value may
  round the other way.
- The MoE on 2 ranks against the local function, f32: output and aux
  within 1e-5; gradients within 1e-5 norm-relative (a sum of two
  partial gradients against the whole rounds otherwise, up to 5e-4 on
  single entries of the router's). ``tp`` on full tensors on (1, 2):
  every rank's token and router gradients whole, with no sum in the
  test; an F-sharded weight's on this rank's slice, summed over the
  group. Both strategies on DTensors placed as the launcher places
  them, on (1, 2) and on the data-parallel (2, 1): every gradient, read
  whole.
- The launcher on 2 ranks, reduced tinyllama-1.1b in f32 at a learning
  rate of 1e-2 (so each step moves the weights), 3 steps: on the host
  mesh (1, 2) and on a (2, 1) mesh with ZeRO-1, per-step total losses
  within 1e-5 (relative) of one rank's; each block's input holds the
  whole batch on (1, 2) and half of it on (2, 1), where every weight
  keeps its placements and every moment shard has the shape and
  placements ``zero1_pspec`` gives; the checkpoint written on 2 ranks
  restores on 1 rank with ``shardings=`` and the resumed step is within
  1e-5 of the uninterrupted one-rank run.
"""
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
MOE_TOL = 1e-5

sys.path.insert(0, str(ROOT / "tests"))
import torch_dist_ranks as TR  # noqa: E402
from torch_dist_ranks import env, spawn  # noqa: E402

REF_REDUCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compression import (compressed_allreduce,
                                            make_compressed_grad_fn)
    from repro.parallel.sharding import shard_map
    sys.path.insert(0, "tests")
    from torch_dist_ranks import reduce_inputs
    x, params, batch = reduce_inputs()
    mesh = jax.make_mesh((4,), ("data",))
    red = shard_map(lambda v: compressed_allreduce(v, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P("data"),
                    axis_names={"data"})
    def loss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    grad = shard_map(make_compressed_grad_fn(loss, mesh), mesh=mesh,
                     in_specs=(P(), P("data")), out_specs=P(),
                     axis_names={"data"}, check_vma=False)
    with mesh:
        y = jax.jit(red)(jnp.asarray(x.reshape(-1)))
        g = jax.jit(grad)(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, batch))
    np.savez(sys.argv[1], y=np.asarray(y).reshape(4, -1),
             gw=np.asarray(g["w"]), gb=np.asarray(g["b"]))
""")


# ---------------------------------------------------------------- reduction
@pytest.fixture(scope="module")
def reduce_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("reduce")
    ref = out / "ref.npz"
    ref_env = env(JAX_PLATFORMS="cpu")
    ref_env.pop("XLA_FLAGS", None)
    ranks = spawn("reduce", 4, out, extra=[
        ([sys.executable, "-c", REF_REDUCE, str(ref)], ref_env)])
    return ranks, dict(np.load(ref))


def _within_one_step(got, want):
    """|got − want| within one int8 step of want's block (BLOCK values of
    the flat, padded array)."""
    from repro_torch.parallel.compression import BLOCK

    g, w = got.reshape(-1), want.reshape(-1)
    pad = (-w.size) % BLOCK
    blocks = np.pad(np.abs(w), (0, pad)).reshape(-1, BLOCK)
    step = np.repeat(np.maximum(blocks.max(1) / 127.0, 1e-12), BLOCK)
    err = np.abs(g - w)
    assert np.all(err <= step[:w.size] * (1 + 1e-6)), float(
        (err / step[:w.size]).max())


def test_compressed_allreduce_matches_reference_4_ranks(reduce_runs):
    ranks, ref = reduce_runs
    x, _, _ = TR.reduce_inputs()
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["y"], ref["y"][i], rtol=2.0 ** -22,
                                   atol=0)
    # every rank holds the same sum, near the exact one
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["y"], ranks[0]["y"])
    s = x.astype(np.float64).sum(0)
    assert np.abs(ranks[0]["y"] - s).max() <= 0.05 * np.abs(s).max()


def test_compressed_grad_fn_matches_reference_4_ranks(reduce_runs):
    ranks, ref = reduce_runs
    for r in ranks:
        for k in ("gw", "gb"):
            _within_one_step(r[k], ref[k])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["gw"], ranks[0]["gw"])


# ---------------------------------------------------------------- 2 ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two")
    return spawn("two", 2, out), out


@pytest.fixture(scope="module")
def one_rank():
    """The launcher alone in this process (one rank: no process group),
    reduced tinyllama-1.1b in f32, 4 steps."""
    with TR.f32_launcher() as lt:
        return lt.train(TR.launcher_args(steps=4),
                        lt.meshes.make_host_mesh("cpu"))


def _check_moe(r, key: str, tag: str):
    """``tag``'s run of ``key`` against the local one on rank ``r``."""
    np.testing.assert_allclose(r[f"{key}/{tag}_out"], r[f"{key}/local_out"],
                               rtol=MOE_TOL, atol=MOE_TOL)
    assert abs(r[f"{key}/{tag}_aux"] - r[f"{key}/local_aux"]) <= \
        MOE_TOL * abs(r[f"{key}/local_aux"])
    local = {k.split("local_grad_")[1]: v for k, v in r.items()
             if k.startswith(f"{key}/local_grad_")}
    assert "x" in local and "router" in local
    for name, g in local.items():
        got = r[f"{key}/{tag}_grad_{name}"]
        rel = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert rel <= MOE_TOL, (key, tag, name, rel)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_tp_on_1x2_mesh_matches_local(two_ranks, arch):
    """Full tensors on every rank: each rank's output, aux, token and
    router gradients equal the local function's, with no sum in the
    test; an F-sharded weight's gradient lies on this rank's slice (zero
    elsewhere), so those sum over the group to the whole."""
    ranks, _ = two_ranks
    key = f"1x2/{arch}/tp"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/mesh_out"], r[f"{key}/local_out"],
                                   rtol=MOE_TOL, atol=MOE_TOL)
        assert abs(r[f"{key}/mesh_aux"] - r[f"{key}/local_aux"]) <= \
            MOE_TOL * abs(r[f"{key}/local_aux"])
        for name in ("x", "router"):
            g = r[f"{key}/local_grad_{name}"]
            got = r[f"{key}/mesh_grad_{name}"]
            rel = np.linalg.norm(got - g) / np.linalg.norm(g)
            assert rel <= MOE_TOL, (name, rel)
    local = {k.split("local_grad_")[1]: v for k, v in ranks[0].items()
             if k.startswith(f"{key}/local_grad_")}
    for name, g in local.items():
        if name in ("x", "router"):
            continue
        got = sum(r[f"{key}/mesh_grad_{name}"] for r in ranks)
        rel = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert rel <= MOE_TOL, (name, rel)


@pytest.mark.parametrize("layout", ["p0g0", "p1g0", "p0g1", "p1g1"])
@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_dense_decode_on_dtensors_matches_local(two_ranks, mesh, kv, layout):
    """Two decode steps with the weights and the cache placed by their
    specs (one KV head: the cache's sequence over "model"; two: its
    heads), in each (partials, grouped) layout of the dense decode: the
    logits within 1e-5 of the local decode's (the paged kernel's plain
    version); each rank's cache writes land exactly where the local
    ones do, their values within 1e-5 (the second step's keys and
    values come from the first step's sums, in other orders)."""
    ranks, _ = two_ranks
    key = f"{mesh}/decode_kv{kv}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/{layout}_logits"],
                                   r[f"{key}/local_logits"],
                                   rtol=1e-5, atol=1e-5)
        for name in ("k", "v"):
            got, want = r[f"{key}/{layout}_{name}"], r[f"{key}/local_{name}"]
            init = r[f"{key}/init_{name}"]
            written = want != init
            assert written.any()
            np.testing.assert_array_equal(got != init, written)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("strategy", ["tp", "ep"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_on_dtensors_matches_local(two_ranks, arch, strategy, mesh):
    """Weights placed by their specs and tokens sharded over "data", as
    the launcher places them: the output, aux and every gradient (read
    whole; the tokens' and router's included) within 1e-5 of the local
    function's on every rank (``tp`` on (2, 1): run shard by shard, its
    aux the mean of the shards', as ``tp`` routes each data shard's
    tokens apart)."""
    ranks, _ = two_ranks
    for r in ranks:
        _check_moe(r, f"{mesh}/{arch}/{strategy}", "dtensor")


def test_launcher_on_2_ranks_matches_1_rank(two_ranks, one_rank):
    """On the host mesh (1, 2) and on the data-parallel (2, 1) mesh with
    ZeRO-1, each step within 1e-5 of one rank's (the row-parallel
    products sum their halves, and the data ranks their gradients, in
    another order); each block's residual stream holds the whole batch
    of 4 on (1, 2) and its half, 2 rows, on (2, 1)."""
    ranks, _ = two_ranks
    want = np.array([m["total_loss"] for m in one_rank[:3]])
    for r in ranks:
        np.testing.assert_allclose(r["host_loss"], want, rtol=LOSS_RTOL,
                                   atol=0)
        np.testing.assert_allclose(r["zero1_loss"], want, rtol=LOSS_RTOL,
                                   atol=0)
        assert len(r["host_block_batch"]) > 0
        assert set(r["host_block_batch"].tolist()) == {4}
        assert len(r["zero1_block_batch"]) > 0
        assert set(r["zero1_block_batch"].tolist()) == {2}


def test_zero1_moment_shards_follow_zero1_pspec(two_ranks):
    ranks, _ = two_ranks
    for r in ranks:
        assert str(r["zero1_bad"]) == ""


def test_2_rank_checkpoint_restores_on_1_rank(two_ranks, one_rank):
    """The (1, 2) run's final checkpoint (step 3, gathered and written by
    rank 0) restored on one rank through ``--resume`` (``restore(...,
    shardings=)``), one more step: within 1e-5 of the one-rank run's
    step 3."""
    _, out = two_ranks
    with TR.f32_launcher() as lt:
        resumed = lt.main(["--reduced", "--device", "cpu", "--steps", "4",
                           "--seq", "32", "--batch", "4", "--resume",
                           "--ckpt-dir", str(out / "ckpt")])
    assert [m["step"] for m in resumed] == [3]
    np.testing.assert_allclose(resumed[0]["total_loss"],
                               one_rank[3]["total_loss"], rtol=LOSS_RTOL,
                               atol=0)
    assert not torch.distributed.is_initialized()
