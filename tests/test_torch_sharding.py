"""The port's sharding layer against the JAX package's, in one process
on the CPU (no process group): the spec logic of
``repro_torch.parallel.sharding`` and ``repro_torch.launch.specs`` equal
to the reference's, entry for entry, on the reference tests' meshes
(``tests/test_dryrun_units.py``'s FakeMesh, 16 × 16, and a 2 × 16 × 16
multi-pod one); ``params_pspecs`` over the five archs of
``test_param_pspecs_cover_all_leaves`` at their full configs (the port
builds them on ``meta``, the reference through ``jax.eval_shape``); the
launcher's per-layer specs; and ``tests/test_moe_strategies.py``'s three
MoE cases on the port, at its 1e-5. The multi-rank parts are in
``test_torch_distributed.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.configs import shape_applicable
from repro.launch import specs as RS
from repro.models import build_model as ref_build
from repro.models.moe import moe_params
from repro.parallel import sharding as RSh
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.launch import specs as PS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as PM
from repro_torch.models.model import weight_tree
from repro_torch.parallel import sharding as PSh

PSPEC_ARCHS = ("tinyllama-1.1b", "arctic-480b", "rwkv6-3b", "zamba2-2.7b",
               "whisper-small")


class FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((16, 16), object)


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    devices = np.empty((2, 16, 16), object)


def one_rank_mesh():
    """A (1, 1) data × model mesh with no process group behind it."""
    return PSh.Mesh(None, ("data", "model"), np.zeros((1, 1), int))


def flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict, jax PartitionSpecs and the
    port's P both as plain tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tuple(tree) if isinstance(tree, (JP, tuple)) else tree}


def ref_flat(tree):
    return flat(jax.tree.map(lambda s: s, tree,
                             is_leaf=lambda x: isinstance(x, JP)))


def meta_tree(arch):
    """The port's full-config weights on ``meta`` in the reference's
    stacked layout, and the reference's ShapeDtypeStruct tree."""
    model = build_model(get_config(arch), device="meta", trainable=True)
    tree = weight_tree(model.params,
                       lambda n, p: torch.empty(p.shape, device="meta"))
    sds = jax.eval_shape(ref_build(ref_config(arch)).init_params,
                         jax.random.key(0))
    return model, tree, sds


# ---------------------------------------------------------------- specs
FIT_CASES = [((32, 100), (None, "model")), ((32, 128), (None, "model")),
             ((51865,), ("model",)), ((64, 48), (("data", "model"), None)),
             ((4096, 11008), (None, ("pod", "data"))), ((7,), (None,))]


@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakePodMesh])
@pytest.mark.parametrize("shape,spec", FIT_CASES)
def test_fit_spec_equals_reference(mesh_cls, shape, spec):
    got = PSh.fit_spec(shape, PSh.P(*spec), mesh_cls())
    assert tuple(got) == tuple(RSh.fit_spec(shape, JP(*spec), mesh_cls()))
    assert isinstance(got, PSh.P)


def test_fit_spec_drops_nondivisible():
    """``test_dryrun_units.py::test_fit_spec_drops_nondivisible``."""
    fm = FakeMesh()
    P = PSh.P
    assert PSh.fit_spec((32, 100), P(None, "model"), fm) == P(None, None)
    assert PSh.fit_spec((32, 128), P(None, "model"), fm) == P(None, "model")
    assert PSh.fit_spec((51865,), P("model"), fm) == P(None)
    assert PSh.fit_spec((3, 5), P(None, "model")) == P(None, "model")


@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakePodMesh])
@pytest.mark.parametrize("spec,shape", [
    ((None, "model"), (4096, 11008)), ((None, None), (7, 4096)),
    (("model", None), (32000, 2048)), ((), (22, 2048)), ((), (7, 3)),
    ((None, None, "model"), (16, 8, 2048))])
def test_zero1_pspec_equals_reference(mesh_cls, spec, shape):
    got = PSh.zero1_pspec(PSh.P(*spec), shape, mesh_cls())
    assert tuple(got) == tuple(RSh.zero1_pspec(JP(*spec), shape,
                                               mesh_cls()))


def test_zero1_shards_first_divisible_dim():
    """``test_dryrun_units.py::test_zero1_shards_first_divisible_dim``."""
    P = PSh.P
    assert PSh.zero1_pspec(P(None, "model"), (4096, 11008),
                           FakeMesh()) == P("data", "model")
    assert PSh.zero1_pspec(P(None, None), (7, 4096),
                           FakeMesh()) == P(None, "data")


@pytest.mark.parametrize("path", [
    "tok/embed", "tok/unembed", "layers/moe/w_gate", "layers/moe/w_down",
    "layers/moe/router", "layers/attn/wq", "layers/cross/wk",
    "layers/channel_mix/wk", "layers/channel_mix/wv", "layers/mlp/w_down",
    "layers/time_mix/w_mix2", "blocks/mamba/mamba/conv_w", "ln_f/scale",
    "blocks/shared/fuse"])
@pytest.mark.parametrize("scan_dims", [0, 1, 2])
def test_param_pspec_equals_reference(path, scan_dims):
    assert tuple(PSh.param_pspec(path, None, scan_dims=scan_dims)) == \
        tuple(RSh.param_pspec(path, None, scan_dims=scan_dims))


@pytest.mark.parametrize("moe_tp", [False, True])
@pytest.mark.parametrize("arch", PSPEC_ARCHS)
def test_params_pspecs_equal_reference_full_configs(arch, moe_tp):
    """Leaf for leaf, as tuples, on the same paths and stacked shapes."""
    _, tree, sds = meta_tree(arch)
    got = flat(PSh.params_pspecs(tree, moe_tp=moe_tp))
    want = ref_flat(RSh.params_pspecs(sds, moe_tp=moe_tp))
    assert got == want
    shapes = flat(jax.tree.map(lambda s: tuple(s.shape), sds))
    assert {k: tuple(v.shape) for k, v in flat(tree).items()} == shapes
    for path, spec in got.items():
        assert len(spec) <= len(shapes[path]), path


@pytest.mark.parametrize("arch", PSPEC_ARCHS)
def test_module_pspecs_drop_only_scan_entries(arch):
    """Each per-layer weight's spec is its stacked leaf's without the
    leading scan entries, which are None (two of them under the
    hybrid's ``mamba``)."""
    model, tree, _ = meta_tree(arch)
    stacked = flat(PSh.params_pspecs(tree))
    per = PSh.module_pspecs(model.params)
    # the weights stacked into each leaf, by ``weight_tree`` itself: each
    # leaf the stack of its weights' indices
    named = list(model.params.named_parameters())
    ids = {n: i for i, (n, _) in enumerate(named)}
    names = {path: [named[i][0] for i in t.reshape(-1).tolist()]
             for path, t in flat(weight_tree(
                 model.params, lambda n, p: torch.tensor(ids[n]))).items()}
    assert sorted(n for ns in names.values() for n in ns) == \
        sorted(n for n, _ in model.params.named_parameters())
    for path, ns in names.items():
        for n in ns:
            drop = len(stacked[path]) - len(per[n])
            assert stacked[path][:drop] == (None,) * drop
            assert tuple(per[n]) == stacked[path][drop:]
            assert len(per[n]) <= model.params.get_parameter(n).ndim


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakePodMesh])
@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "olmoe-1b-7b",
                                  "zamba2-2.7b"))
def test_state_pspecs_equal_reference(arch, mesh_cls, zero1):
    _, tree, sds = meta_tree(arch)
    got = PS.state_pspecs(tree, None, mesh_cls(), zero1=zero1)
    want = RS.state_pspecs(sds, None, mesh_cls(), zero1=zero1)
    assert flat(got[0]) == ref_flat(want[0])
    assert flat(got[1]) == ref_flat(want[1])


@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakePodMesh])
@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-small",
                                  "llava-next-34b"))
def test_input_and_cache_pspecs_equal_reference(arch, mesh_cls):
    """Every applicable shape's input specs (the decode cache among
    them) through ``input_pspecs``, and the cache through
    ``cache_pspecs`` directly."""
    pm = build_model(get_config(arch), device="meta")
    rm = ref_build(ref_config(arch))
    seen = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(ref_config(arch), REF_SHAPES[name]):
            continue
        got = PS.input_pspecs(pm.cfg, pm.input_specs(shape), mesh_cls())
        want = RS.input_pspecs(rm.cfg, rm.input_specs(REF_SHAPES[name]),
                               mesh_cls())
        assert flat(got) == ref_flat(want), name
        seen += 1
        if shape.kind == "decode":
            c = PS.cache_pspecs(pm.cfg, pm.input_specs(shape)["cache"],
                                mesh_cls())
            assert flat(c) == ref_flat(RS.cache_pspecs(
                rm.cfg, rm.input_specs(REF_SHAPES[name])["cache"],
                mesh_cls()))
    assert seen


def test_state_shardings_zero1_per_layer_weights():
    """On a (2, 1) data × model mesh, no weight is sharded over "data",
    and each moment is, on the first dim of the per-layer weight that 2
    divides and no other entry names."""
    mesh = PSh.Mesh(None, ("data", "model"), np.zeros((2, 1), int))
    model = build_model(get_reduced("tinyllama-1.1b"), device="meta",
                        trainable=True)
    sh = PS.StateShardings.of(model.params, mesh, zero1=True)
    for n, p in model.params.named_parameters():
        assert "data" not in sh.params[n], n
        assert sh.moments[n] == PSh.zero1_pspec(sh.params[n], p.shape, mesh)
        assert "data" in sh.moments[n], n


# ---------------------------------------------------------------- mesh
def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = PSh.Mesh(None, ("pod", "data", "model"), np.zeros((2, 2, 2)))
    assert PSh.placements(PSh.P(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert PSh.placements(PSh.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert PSh.placements(PSh.P(), mesh) == (Replicate(),) * 3


def test_constrain_is_a_noop_without_a_mesh():
    x = torch.randn(4, 8)
    assert PSh.current_mesh() is None
    assert PSh.constrain(x, "batch", "model") is x
    assert PSh.data_axes() == ("data",)
    with PSh.use_mesh(one_rank_mesh()) as m:
        assert PSh.current_mesh() is m
        assert PSh.constrain(x, "batch", "model") is x   # a plain tensor
        assert PSh.data_axes() == ("data",)
    assert PSh.current_mesh() is None


def test_make_production_mesh_raises_at_world_1(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="needs 256 ranks; this run has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- moe tp
def _moe(strategy):
    """``test_moe_strategies.py``'s setup on both packages: reduced
    olmoe-1b-7b in f32 at capacity factor 8, the reference's
    ``moe_params(key(0))`` loaded into the port's MoE, x from key(1)."""
    rcfg = dataclasses.replace(ref_reduced("olmoe-1b-7b",
                                           capacity_factor=8.0),
                               dtype="float32", moe_strategy=strategy)
    pcfg = dataclasses.replace(get_reduced("olmoe-1b-7b",
                                           capacity_factor=8.0),
                               dtype="float32", moe_strategy=strategy)
    rp = moe_params(jax.random.key(0), rcfg)
    pm = PM.MoE(pcfg, torch.Generator().manual_seed(0), "cpu")
    pm.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in rp.items()})
    return pcfg, pm


def _x(B, S, D):
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.key(1), (B, S, D))))


def test_tp_matches_ep_no_mesh():
    cfg_ep, pm = _moe("ep")
    cfg_tp = dataclasses.replace(cfg_ep, moe_strategy="tp")
    x = _x(2, 16, cfg_ep.d_model)
    out_ep, aux_ep = PM.moe_ffn(pm, x, cfg_ep)
    out_tp, aux_tp = PM.moe_ffn(pm, x, cfg_tp)
    np.testing.assert_allclose(out_ep.numpy(), out_tp.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_ep), float(aux_tp), rtol=1e-5)


def test_tp_under_mesh_matches_local():
    cfg_tp, pm = _moe("tp")
    x = _x(2, 16, cfg_tp.d_model)
    out_local, aux_local = PM.moe_ffn(pm, x, cfg_tp)
    with PSh.use_mesh(one_rank_mesh()):
        out_mesh, aux_mesh = PM.moe_ffn(pm, x, cfg_tp)
    np.testing.assert_allclose(out_local.numpy(), out_mesh.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_local), float(aux_mesh), rtol=1e-5)


@pytest.mark.parametrize("mesh", [None, "one_rank"])
def test_tp_grads_flow(mesh):
    cfg_tp, pm = _moe("tp")
    pm.requires_grad_(True)
    x = _x(1, 8, cfg_tp.d_model)
    with PSh.use_mesh(one_rank_mesh()) if mesh else torch.enable_grad():
        out, aux = PM.moe_ffn(pm, x, cfg_tp)
        loss = torch.sum(out ** 2) + 0.01 * aux
    names, params = zip(*pm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    for g in grads.values():
        assert torch.isfinite(g).all()
    assert float(grads["w_gate"].abs().max()) > 0
