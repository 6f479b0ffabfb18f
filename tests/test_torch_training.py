"""The port's training substrate against the JAX package (CPU, reduced
configs, vocab 64): the optimizer and its schedule, train steps on the
reference's batches, convergence, checkpoints (and reading each other's),
resume, int8 gradient compression and the train launcher.

Tolerances: the schedule equal to the reference's to f32 rounding;
AdamW's params, m and v within 1e-6 relative over 20 updates; five
train steps with per-step loss within 1e-4 relative in f32 (1e-2 in
bf16) and the final params within 1e-3 norm-relative per leaf in f32;
int8 quantisation equal to the reference's, with the same scales;
checkpoint leaves equal across the packages; resume bit-exact."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTC
from repro.data.pipeline import make_pipeline as ref_pipeline
from repro.models import build_model as ref_build
from repro.parallel import compression as RC
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as RO
from repro.training.train_step import TrainState as RefState
from repro.training.train_step import init_train_state as ref_init_state
from repro.training.train_step import make_train_step as ref_train_step
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models import build_model, params_to_jax
from repro_torch.parallel.compression import (compress_roundtrip,
                                              dequantize_int8,
                                              maybe_compress_grads,
                                              quantize_int8)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (adamw_update, init_opt_state,
                                            warmup_cosine)
from repro_torch.training.train_step import (init_train_state,
                                             make_train_step, state_tree)
from torch_train_parity import cfgs, leaves, port_model, ref_params, rel

ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe(cfg, seq, batch):
    return make_pipeline(cfg, ShapeConfig("tiny", seq, batch, "train"),
                         seed=0)


# ---------------------------------------------------------------- optimizer
def test_adamw_minimises_quadratic():
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=0,
                     total_steps=1000)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, tc)
    assert float(params["w"].abs().max()) < 0.05


@pytest.mark.parametrize("step", (0, 10, 55, 100))
def test_lr_schedule_equals_reference(step):
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    ref = float(RO.warmup_cosine(tc)(jnp.array(step)))
    got = warmup_cosine(tc)(torch.tensor(step))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(ref, rel=1e-6, abs=1e-12)
    if step == 0:
        assert float(got) == 0.0
    if step == 55:
        assert float(got) < 1e-3


def test_adamw_update_matches_reference_over_20_updates():
    """Params, m and v within 1e-6 relative of the reference's after
    each of 20 updates on the same seeded gradients, clipping and weight
    decay on (an element near zero relative to its leaf's largest: XLA
    may fuse a multiply-add that torch rounds twice)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (33, 7), "b": (5,), "c": (2, 3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=3, total_steps=20,
                     grad_clip=0.5)
    rp, rop = {k: jnp.asarray(v) for k, v in p0.items()}, None
    rop = RO.init_opt_state(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pop = init_opt_state(pp)
    upd = jax.jit(lambda p, g, o: RO.adamw_update(p, g, o, tc))
    for _ in range(20):
        g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
        rp, rop, rmet = upd(rp, {k: jnp.asarray(v) for k, v in g.items()},
                            rop)
        pp, pop, pmet = adamw_update(pp, {k: torch.from_numpy(v)
                                          for k, v in g.items()}, pop, tc)
        assert float(pmet["grad_norm"]) == pytest.approx(
            float(rmet["grad_norm"]), rel=1e-6)
        assert float(pmet["lr"]) == pytest.approx(float(rmet["lr"]),
                                                  rel=1e-6)
        for name, (r, p) in {"params": (rp, pp), "m": (rop.m, pop.m),
                             "v": (rop.v, pop.v)}.items():
            for k in shapes:
                want = np.asarray(r[k])
                np.testing.assert_allclose(
                    p[k].numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()),
                    err_msg=f"{name} {k}")
    assert int(pop.step) == int(rop.step) == 20


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("dtype,loss_rtol", (("float32", 1e-4),
                                             ("bfloat16", 1e-2)))
def test_train_steps_match_reference(dtype, loss_rtol):
    """Five steps from the same weights on the reference's own batches
    (its pipeline, its jitted step)."""
    rcfg, pcfg = cfgs(ARCH, dtype)
    tc = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    shape = ShapeConfig("tiny", 32, 8, "train")
    rpipe = ref_pipeline(rcfg, shape, seed=0)
    rm = ref_build(rcfg)
    rparams = jax.tree.map(jnp.asarray, ref_params(ARCH))
    rstate = RefState(rparams, RO.init_opt_state(rparams))
    rstep = jax.jit(ref_train_step(rm, RefTC(**tc)))
    _, pm, pp = port_model(ARCH, dtype)
    pstate = init_train_state(pm, params=pp)
    pstep = make_train_step(pm, TrainConfig(**tc))
    for i in range(5):
        batch = rpipe.batch(i)
        rstate, rmet = rstep(rstate, batch)
        pstate, pmet = pstep(pstate, {k: torch.from_numpy(np.array(v))
                                      .long() for k, v in batch.items()})
        for k in ("loss", "total_loss"):
            assert float(pmet[k]) == pytest.approx(float(rmet[k]),
                                                   rel=loss_rtol), (i, k)
    assert int(pstate.opt.step) == 5
    if dtype == "float32":
        got = params_to_jax(pstate.params)
        for (path, r), (_, p) in zip(leaves(jax.tree.map(
                np.asarray, rstate.params)), leaves(got)):
            assert rel(p, r) <= 1e-3, path


def _losses(cfg, tc, steps, seq=32, batch=8):
    model = build_model(cfg, device="cpu", trainable=True)
    state = init_train_state(model)
    step = make_train_step(model, tc)
    pipe = _pipe(cfg, seq, batch)
    losses = []
    for i in range(steps):
        state, metrics = step(state, pipe.batch(i))
        losses.append(float(metrics["loss"]))
    return losses


def test_train_loop_loss_decreases():
    _, cfg = cfgs(ARCH, "bfloat16")
    losses = _losses(cfg, TrainConfig(learning_rate=3e-3, warmup_steps=5,
                                      total_steps=60), 40)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, f"{losses[0]} -> {losses[-1]}"


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.latest_steps(d) == [3, 4]
    step, restored = ckpt.restore(d, tree)
    assert step == 4
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_async_commit_from_a_host_copy(tmp_path):
    """The writer works from the copy ``save`` took: changing the tree
    after it returns does not reach the checkpoint."""
    tree = {"w": torch.zeros((64, 64))}
    d = str(tmp_path / "ck")
    t = ckpt.save(d, 7, tree, async_=True)
    tree["w"].fill_(1.0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert ckpt.latest_steps(d) == [7]
    _, restored = ckpt.restore(d, tree)
    assert float(restored["w"].abs().max()) == 0.0


def test_checkpoint_ignores_uncommitted(tmp_path):
    tree = {"w": torch.zeros((4,))}
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tree)
    os.makedirs(d + "/step_00000002")       # crash mid-write: no COMMITTED
    assert ckpt.latest_steps(d) == [1]
    step, _ = ckpt.restore(d, tree)
    assert step == 1


def test_checkpoints_cross_between_packages(tmp_path):
    """A train state the reference wrote restores in the port (the
    weights and moments its leaves hold, the step), and the port's
    restores in the reference, leaf for leaf — bf16 leaves included."""
    rcfg, pcfg = cfgs("olmoe-1b-7b", "bfloat16")
    rstate = ref_init_state(ref_build(rcfg), jax.random.key(0))
    rstate = rstate._replace(opt=rstate.opt._replace(
        step=jnp.int32(3), m=jax.tree.map(lambda x: x + 0.5, rstate.opt.m)))
    ref_ckpt.save(str(tmp_path / "r"), 3, rstate)
    pm = build_model(pcfg, device="cpu", trainable=True)
    step, pstate = ckpt.restore(str(tmp_path / "r"), init_train_state(pm, 1))
    assert step == 3 and int(pstate.opt.step) == 3
    got = state_tree(pstate, leaf=lambda t: t.float())
    assert len(leaves(got)) == len(jax.tree.leaves(rstate))
    for (_, p), r in zip(leaves(got), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r, np.float32))

    ckpt.save(str(tmp_path / "p"), 5, pstate)
    step, back = ref_ckpt.restore(str(tmp_path / "p"), rstate)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    bf = {"x": torch.randn(3, 5).bfloat16(), "n": torch.arange(4)}
    ckpt.save(str(tmp_path / "b"), 1, bf)
    _, rb = ref_ckpt.restore(str(tmp_path / "b"), {
        "x": jnp.zeros((3, 5), jnp.bfloat16),
        "n": jnp.zeros((4,), jnp.int32)})
    assert rb["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(rb["x"], np.float32),
                                  bf["x"].float().numpy())
    ref_ckpt.save(str(tmp_path / "rb"), 1, {"x": rb["x"]})
    _, pb = ckpt.restore(str(tmp_path / "rb"), {"x": bf["x"]})
    assert torch.equal(pb["x"], bf["x"])


def test_train_resume_bitexact(tmp_path):
    """Kill after step 3, restore into a fresh state, continue: identical
    to an uninterrupted run."""
    _, cfg = cfgs(ARCH, "bfloat16")
    model = build_model(cfg, device="cpu", trainable=True)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0)
    pipe = _pipe(cfg, 16, 4)
    step_fn = make_train_step(model, tc)

    state = init_train_state(model)
    for i in range(6):
        state, m = step_fn(state, pipe.batch(i))
    uninterrupted = float(m["total_loss"])

    state2 = init_train_state(model)
    d = str(tmp_path / "ck")
    for i in range(3):
        state2, _ = step_fn(state2, pipe.batch(i))
    ckpt.save(d, 3, state2, async_=True).join(timeout=60)
    start, state3 = ckpt.restore(d, init_train_state(model, seed=1))
    for i in range(start, 6):
        state3, m3 = step_fn(state3, pipe.batch(i))
    assert float(m3["total_loss"]) == uninterrupted


# ---------------------------------------------------------------- compression
@pytest.mark.parametrize("shape", ((1000,), (20, 15), (256,), (3, 256, 2)))
def test_quantize_int8_equals_reference(shape):
    x = (np.random.default_rng(0).normal(size=shape) * 3).astype(np.float32)
    rq, rs, rshape = RC.quantize_int8(jnp.asarray(x))
    q, s, pshape = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and pshape == tuple(rshape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        dequantize_int8(q, s, pshape).numpy(),
        np.asarray(RC.dequantize_int8(rq, rs, rshape)))


def test_quantize_roundtrip_error_bound():
    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32) * 3
    y = compress_roundtrip(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(x - y)) <= np.max(np.abs(x)) / 254 + 1e-6


def test_quantize_shapes_and_padding():
    x = torch.arange(300, dtype=torch.float32).reshape(20, 15)
    q, s, shp = quantize_int8(x)
    assert q.shape == (2, 256) and s.shape == (2,)
    assert torch.all(q[1, 300 - 256:] == 0)           # the zero padding
    y = dequantize_int8(q, s, shp)
    assert y.shape == (20, 15)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1.2)


def test_maybe_compress_grads_small_leaves_passthrough():
    g = {"big": torch.ones((128, 64)), "small": torch.ones((8,))}
    out = maybe_compress_grads(g, threshold=4096)
    assert out["small"] is g["small"]
    np.testing.assert_allclose(out["big"].numpy(), g["big"].numpy(),
                               atol=0.02)


def test_compressed_grad_step_still_learns():
    _, cfg = cfgs(ARCH, "bfloat16")
    losses = _losses(cfg, TrainConfig(learning_rate=3e-3, warmup_steps=5,
                                      grad_compression="int8"), 30)
    assert losses[-1] < losses[0] - 0.2


# ---------------------------------------------------------------- launcher
def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main

    d = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq", "16",
            "--batch", "4", "--ckpt-dir", d, "--ckpt-every", "2"]
    main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step    2 loss=" in out
    assert ckpt.latest_steps(d) == [2, 3]
    main(args + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert "step    3 loss=" in out and "step    2 loss=" not in out
    assert ckpt.latest_steps(d) == [3, 4, 5]
    with pytest.raises(RuntimeError, match="needs 256 ranks; this run has 1"):
        main(args + ["--production-mesh"])
