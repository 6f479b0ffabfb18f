"""The port's dry-run (``repro_torch.launch.dryrun``, ``.sweep``) against
the reference's (``tests/test_dryrun_units.py``'s checks, and the
accounting itself): the carried host code bit for bit, the functional
collectives counted as the HLO parser counts them, the per-rank counts
against a real step and across mesh shapes, the state's shard bytes
against the reference's specs, and the sweep's extrapolation. Every
fake process group is gone after each test."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

_xla_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as RD  # noqa: E402  (sets XLA_FLAGS at import)
import repro.launch.sweep as RSW  # noqa: E402
from test_dryrun_units import HLO_SAMPLE  # noqa: E402

# the reference's modules ask for 512 host devices when they are imported;
# nothing here compiles on them, so later files in this worker keep theirs
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sweep as SW  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402

HLO_SAMPLE_2 = """
  %ars = (f32[4096]{0}, f32[4096]{0}) all-reduce-start(%a, %b), replica_groups={{0,1},{2,3}}, to_apply=%add
  %ard = (f32[4096]{0}, f32[4096]{0}) all-reduce-done(%ars)
  %ags = bf16[16,2048]{1,0} all-gather-start(%c), replica_groups=[32,8]<=[256], dimensions={0}
  %rs2 = bf16[64,7168]{1,0} reduce-scatter(%d), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %a2a = u8[1024]{0} all-to-all(%e), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp2 = f32[2,2]{1,0} collective-permute(%f), source_target_pairs={{0,1},{1,0}}
  %use = f32[4096]{0} add(%all-reduce.3, %x)
  %ar2 = s32[] all-reduce(%g), to_apply=%add
"""


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a process group outlived its test"


# ------------------------------------------------------------ host code
@pytest.mark.parametrize("hlo", [HLO_SAMPLE, HLO_SAMPLE_2])
def test_parse_collectives_equals_reference(hlo):
    assert D.parse_collectives(hlo) == RD.parse_collectives(hlo)
    for line in hlo.splitlines():
        assert D._group_size(line) == RD._group_size(line)


def test_constants_are_the_h100s():
    assert (D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert D._DTYPE_BYTES == RD._DTYPE_BYTES
    assert D._OP_RE.pattern == RD._OP_RE.pattern


def test_functional_collectives_count_as_parse_collectives():
    """The rank's functional collectives, one each of HLO_SAMPLE's ops
    but the point-to-point permute (same result shapes and group
    sizes): the counter's dict equals the parser's."""
    import torch.distributed._functional_collectives as funcol

    hlo = "\n".join(line for line in HLO_SAMPLE.splitlines()
                    if "collective-permute" not in line)
    with fake_process_group(16):
        g4, g8 = dist.new_group(list(range(4))), dist.new_group(
            list(range(8)))
        g16 = dist.group.WORLD
        ar, ag = torch.zeros(1024, 512), torch.zeros(8, 128,
                                                     dtype=torch.bfloat16)
        a2a, rs = torch.zeros(128, 256, dtype=torch.int8), torch.zeros(512)
        acct = D.Accountant(None)
        with acct:
            funcol.all_reduce(ar, "sum", g16)
            funcol.all_gather_tensor(ag, 0, g4)
            funcol.all_to_all_single(a2a, None, None, g8)
            funcol.reduce_scatter_tensor(rs, "sum", 0, g4)
    assert D.collectives_from_calls(acct.calls) == \
        RD.parse_collectives(hlo)


def test_model_flops_equal_reference_on_all_40_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            assert D.model_flops(get_config(arch), shape) == \
                RD.model_flops(ref_config(arch), RD.SHAPES[shape.name])


def test_cell_accounting_40_cells():
    cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    assert len(cells) == 40
    runnable = [c for c in cells
                if shape_applicable(get_config(c[0]), SHAPES[c[1]])]
    skipped = [c for c in cells if c not in runnable]
    assert len(runnable) == 33
    assert all(s == "long_500k" for _, s in skipped)
    assert {a for a, s in runnable if s == "long_500k"} == \
        {"rwkv6-3b", "h2o-danube-3-4b", "zamba2-2.7b"}
    for arch, shape in skipped:
        assert D.run_cell(arch, shape, False)["status"] == "skipped"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Names and shapes of every applicable shape's inputs equal the
    reference's; dtypes too, but the port's int64 ids for its int32."""
    import jax.numpy as jnp

    cfg = get_config(arch)
    mine = build_model(cfg, device="meta")
    ref = ref_build(ref_config(arch))
    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape):
            continue
        got, want = _flat(mine.input_specs(shape)), _flat(
            ref.input_specs(RD.SHAPES[shape.name]))
        assert got.keys() == want.keys(), (arch, shape.name)
        for k, spec in got.items():
            assert tuple(spec.shape) == tuple(want[k].shape), (arch, k)
            wdt = want[k].dtype
            if wdt == jnp.int32:
                assert spec.dtype == torch.int64, (arch, k)
            else:
                assert str(spec.dtype).split(".")[1] == str(wdt), (arch, k)


# ------------------------------------------------------------ accounting
def _small_cfg(**kw):
    """tinyllama-1.1b cut to 2 layers and narrow widths (4 heads of 16, 2
    KV heads), selective remat."""
    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b"), num_layers=2, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256,
        vocab_pad_to=32, attn_chunk=32, remat="selective")
    return dataclasses.replace(cfg, **kw)


SMALL_TRAIN = ShapeConfig("small", 64, 8, "train")
ONE_RANK = Mesh(None, ("data", "model"), np.zeros((1, 1), int))


def test_one_rank_count_equals_a_real_steps():
    """The fake one-rank count of a microbatched train step equals
    FlopCounterMode's count of the same step run for real on the CPU,
    and the tracker reads the same bytes and peak off the real step as
    off the fake one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg, tc = _small_cfg(), TrainConfig(microbatches=2)
    fake = D.account_cell("tinyllama-1.1b", SMALL_TRAIN, ONE_RANK, tc,
                          cfg=cfg)
    assert fake["hlo_flops"] > 0 and fake["collectives"]["ops"] == {}
    fn, args, _ = D.build_step("tinyllama-1.1b", SMALL_TRAIN, ONE_RANK,
                                  tc, cfg=cfg)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert fake["hlo_flops"] == fc.get_total_flops()
    fn, args, _ = D.build_step("tinyllama-1.1b", SMALL_TRAIN, ONE_RANK,
                                  tc, cfg=cfg)
    real = D.account(fn, args, FakeTensorMode(allow_non_fake_inputs=True))
    for k in ("hlo_flops", "hlo_bytes", "memory"):
        assert real[k] == fake[k], k
    mem = fake["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_per_rank_times_ranks_matches_one_rank(shape):
    """Per-rank FLOPs × ranks on fake (2, 2) and (4, 1) meshes against
    one rank's: equal exactly (the tolerance found; the ranks' products
    split the one-rank products, and the matrix products are all that
    the FLOP formulas count). The bytes are not held so: a norm or a
    gathered KV head is read and written on every model rank."""
    cfg, tc = _small_cfg(), TrainConfig()
    one = D.account_cell("tinyllama-1.1b", SMALL_TRAIN, ONE_RANK, tc,
                         cfg=cfg)
    n = int(np.prod(shape))
    with fake_process_group(n):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        per = D.account_cell("tinyllama-1.1b", SMALL_TRAIN, mesh, tc,
                             cfg=cfg)
    assert per["collectives"]["wire_bytes_per_chip"] > 0
    assert per["hlo_flops"] * n == one["hlo_flops"]


def test_sharded_product_pair_counts_the_ranks_share():
    """A column- then row-parallel product pair, forward and backward
    from a batch-sharded gradient, on the fake (16, 16) mesh: per-rank
    FLOPs × 256 equal the global count of its five products exactly
    (DTensor's global-shape propagation calls, which would add the
    global count once a call, are left out)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    M, K, N = 2048, 4096, 11008
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_process_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        dm = mesh.device_mesh
        with fm:
            x = distribute_tensor(torch.empty(M, K), dm,
                                  [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(K, N), dm,
                                   [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(N, K), dm,
                                   [Replicate(), Shard(0)])
            g = distribute_tensor(torch.empty(M, K), dm,
                                  [Shard(0), Replicate()])
        w1.requires_grad_(True)
        w2.requires_grad_(True)

        def pair(x, w1, w2, g):
            # forward x·w1, (x·w1)·w2; backward dW2, dH, dW1
            y = (x @ w1) @ w2
            y.backward(g)
            return y
        counts = D.account(pair, (x, w1, w2, g), fm)
    assert counts["hlo_flops"] * 256 == 5 * (2 * M * K * N)


def test_shard_bytes_match_reference_state_pspecs():
    """On a fake (4, 4) mesh (ZeRO-1 off, so the moments shard as the
    weights do) the train state's argument bytes are three times the
    f32 weights' shard bytes that the reference's ``state_pspecs`` give
    on a FakeMesh, plus the step counter and the batch's shards."""
    import jax
    from repro.launch.specs import state_pspecs as ref_state_pspecs

    cfg, tc = _small_cfg(), TrainConfig(zero1=False)

    class FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((4, 4), object)

    ref = ref_build(dataclasses.replace(ref_config("tinyllama-1.1b"),
                                        **{f.name: getattr(cfg, f.name)
                                           for f in dataclasses.fields(cfg)
                                           if f.name != "name"}))
    sds = jax.eval_shape(ref.init_params, jax.random.key(0))
    specs, _ = ref_state_pspecs(sds, None, FakeMesh(), zero1=False)

    def shard_bytes(leaf, spec):
        n = 1
        for d, s in enumerate(leaf.shape):
            axes = spec[d] if d < len(spec) else None
            n *= s // (4 if axes else 1)
        return n * leaf.dtype.itemsize
    params = sum(shard_bytes(leaf, spec) for leaf, spec in zip(
        jax.tree.leaves(sds), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, RD.P))))
    batch = 2 * (SMALL_TRAIN.global_batch // 4) * SMALL_TRAIN.seq_len * 8
    with fake_process_group(16):
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        got = D.account_cell("tinyllama-1.1b", SMALL_TRAIN, mesh, tc,
                             cfg=cfg)
    assert got["memory"]["argument_bytes"] == 3 * params + 4 + batch


def test_fake_group_never_joins_a_group():
    with fake_process_group(2):
        with pytest.raises(RuntimeError, match="up already"):
            with fake_process_group(4):
                pass
        with pytest.raises(RuntimeError, match="up already"):
            D.run_cell("tinyllama-1.1b", "decode_32k", False)


def test_dryrun_cli_prints_the_cell(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
        "--mesh", "single", "--decode-grouped", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        D.main()
    assert e.value.code == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["status"], res["n_chips"], res["tag"]) == ("ok", 256,
                                                           "baseline")
    for k in ("compute_s", "memory_s", "collective_s"):
        assert res[k] > 0
    assert res["memory_s"] == res["hlo_bytes"] / 3.35e12
    assert res["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                  key=res.get)
    saved = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__single__"
                        "baseline.json").read_text())
    assert saved["hlo_flops"] == res["hlo_flops"]


# ------------------------------------------------------------ the sweep
def _stub_cell(arch, shape, multi_pod, tc=None, extra=None, overrides=None):
    """A cell whose counts are affine in its depth."""
    L = overrides["num_layers"]
    out = {"arch": arch, "shape": shape, "status": "ok", "n_chips": 256,
           "hlo_flops": 3.0e12 + 7.5e11 * L, "hlo_bytes": 1.0e11 + 2.5e10 * L,
           "collectives": {"wire_bytes_per_chip": 4.0e9 + 1.25e9 * L,
                           "ops": {}}}
    out.update(extra or {})
    return out


@pytest.mark.parametrize("arch", sorted(RSW.EXTRAPOLATE))
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_extrapolate_equals_reference(arch, shape, monkeypatch):
    monkeypatch.setattr(RD, "run_cell", _stub_cell)
    monkeypatch.setattr(D, "run_cell", _stub_cell)
    assert SW.EXTRAPOLATE[arch] == RSW.EXTRAPOLATE[arch]
    got = SW._extrapolate(arch, shape, False, *SW.EXTRAPOLATE[arch])
    want = RSW._extrapolate(arch, shape, False, *RSW.EXTRAPOLATE[arch])
    for k in ("hlo_flops", "hlo_bytes", "extrapolated_from", "tag",
              "model_flops", "model_flops_per_chip", "useful_flops_frac"):
        assert got[k] == want[k], k
    assert got["collectives"]["wire_bytes_per_chip"] == \
        want["collectives"]["wire_bytes_per_chip"]
    assert got["compute_s"] == got["hlo_flops"] / D.PEAK_FLOPS


def test_sweep_records_skips_and_resumes(tmp_path, capsys):
    SW.main(["--mesh", "single", "--arch", "granite-8b", "--shapes",
             "long_500k", "--out", str(tmp_path)])
    f = tmp_path / "granite-8b__long_500k__single__baseline.json"
    assert json.loads(f.read_text())["status"] == "skipped"
    assert "-> skipped" in capsys.readouterr().out
    SW.main(["--mesh", "single", "--arch", "granite-8b", "--shapes",
             "long_500k", "--out", str(tmp_path)])
    assert "-> cached" in capsys.readouterr().out
