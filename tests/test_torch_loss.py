"""The port's training forward against the JAX package on the same
weights (CPU, reduced configs, vocab 64): ``loss_fn`` and every
gradient leaf for the five families and the vision stub, remat,
microbatched gradients, ``input_specs`` and the weights carried both
ways; and, on the card, the forward-only kernels' gradient guard and
the card's gradients against the CPU's.

Tolerances: in f32 the loss within 1e-5 relative and each gradient leaf
within 1e-4 norm-relative. In bf16 the loss within 1e-2 relative and
each leaf within 2e-2 norm-relative — or, where the reference's own
bf16 gradient is further than that from its f32 one, within
BF16_NOISE_FACTOR times that distance (RWKV-6's bf16 gradients sit
0.03-0.88 from its f32 ones in the reference, the port's 0.05-0.15: a
fixed bf16-vs-bf16 limit would measure where the reference rounds). A
bf16 MoE case whose routing flipped at a near-tie is exempt from the
gradient check, as in ``test_torch_families.py``."""
import contextlib

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.moe as RM
from repro.configs.base import ShapeConfig as RefShape
from repro.models import build_model as ref_build
from repro.configs.base import TrainConfig as RefTC
from repro.training.train_step import make_loss_and_grad as ref_loss_and_grad
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model, params_from_jax, params_to_jax
from repro_torch.models import moe as PM
from repro_torch.models.layers import recording
from torch_train_parity import (ARCHS, cfgs, leaves, port_loss_grads,
                                ref_loss_grads, ref_params, rel, train_batch)

BF16_NOISE_FACTOR = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _routing_log():
    """Each package's router choices, call by call, and for the port's
    the gap between each token's k-th and (k+1)-th probability relative
    to the k-th."""
    port, ref = [], []
    p_topk, r_topk = PM.router_topk, RM.router_topk

    def p_hook(logits, k):
        gates, idx, probs = p_topk(logits, k)
        top = torch.sort(probs, dim=-1, descending=True).values
        port.append((idx.sort(dim=-1).values.numpy(),
                     ((top[:, k - 1] - top[:, k]) / top[:, k - 1])
                     .detach().numpy()))
        return gates, idx, probs

    def r_hook(logits, k):
        gates, idx, probs = r_topk(logits, k)
        jax.debug.callback(lambda i: ref.append(np.sort(np.asarray(i), -1)),
                           idx, ordered=True)
        return gates, idx, probs

    PM.router_topk, RM.router_topk = p_hook, r_hook
    try:
        yield port, ref
    finally:
        PM.router_topk, RM.router_topk = p_topk, r_topk


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    r_loss, r_met, r_g = ref_loss_grads(arch, "float32")
    p_loss, p_met, p_g = port_loss_grads(arch, "float32")
    assert p_loss == pytest.approx(r_loss, rel=1e-5)
    for k in ("loss", "aux", "ntok"):
        assert p_met[k] == pytest.approx(r_met[k], rel=1e-5, abs=1e-7), k
    if arch == "olmoe-1b-7b":
        assert r_met["aux"] > 0            # the MoE load-balance term
    for (path, r), (ppath, p) in zip(leaves(r_g), leaves(p_g)):
        assert path == ppath
        assert rel(p, r) <= 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    with _routing_log() as (port, ref):
        r_loss, r_met, r_g = ref_loss_grads.__wrapped__(arch, "bfloat16")
        p_loss, p_met, p_g = port_loss_grads(arch, "bfloat16")
    assert p_loss == pytest.approx(r_loss, rel=1e-2)
    assert p_met["aux"] == pytest.approx(r_met["aux"], rel=1e-2, abs=1e-6)
    flipped = False
    for (p_idx, gap), r_idx in zip(port, ref):
        rows = (p_idx != r_idx).any(-1)
        assert (gap[rows] < 2.0 ** -6).all(), gap[rows]
        flipped |= bool(rows.any())
    assert len(port) == len(ref)
    if flipped:
        return                          # a near-tie flip: exempt
    _, _, r_g32 = ref_loss_grads(arch, "float32")
    for (path, r), (_, p), (_, r32) in zip(leaves(r_g), leaves(p_g),
                                           leaves(r_g32)):
        limit = max(2e-2, BF16_NOISE_FACTOR * rel(r, r32))
        assert rel(p, r) <= limit, path


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "olmoe-1b-7b",
                                  "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-small"))
def test_remat_modes_give_equal_grads(arch):
    """"full" and "selective" recompute what "none" keeps: the same
    loss and gradients, bit for bit on the CPU."""
    base = port_loss_grads(arch, "float32", remat="none")
    for mode in ("full", "selective"):
        got = port_loss_grads(arch, "float32", remat=mode)
        assert got[0] == base[0], mode
        for (path, a), (_, b) in zip(leaves(got[2]), leaves(base[2])):
            np.testing.assert_array_equal(a, b, err_msg=f"{mode} {path}")


def test_selective_remat_saves_only_unbatched_products():
    """Under "selective" the backward pass recomputes the batched
    products (the attention scores) and none of the unbatched ones
    (``x @ W``): count the products the forward and backward run."""
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[func] = counts.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    runs = {}
    for mode in ("none", "selective"):
        counts.clear()
        with Count():
            port_loss_grads("tinyllama-1.1b", "float32", remat=mode)
        runs[mode] = dict(counts)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert runs["selective"][mm] == runs["none"][mm]
    assert runs["selective"][bmm] > runs["none"][bmm]


def test_microbatching_matches_single_pass_and_reference():
    """1, 2 and 4 microbatches give the single pass's loss and
    gradients (f32 sums in another order), and 4 give the reference's
    4-microbatch ones."""
    arch = "tinyllama-1.1b"
    outs = {n: port_loss_grads(arch, "float32", microbatches=n)
            for n in (1, 2, 4)}
    for n in (2, 4):
        assert outs[n][0] == pytest.approx(outs[1][0], rel=1e-6)
        for (path, a), (_, b) in zip(leaves(outs[n][2]), leaves(outs[1][2])):
            assert rel(a, b) <= 1e-5, (n, path)
    rcfg, _ = cfgs(arch, "float32")
    rm = ref_build(rcfg)
    loss, metrics, grads = jax.jit(ref_loss_and_grad(rm, RefTC(
        microbatches=4)))(ref_params(arch), train_batch(rcfg))
    assert outs[4][0] == pytest.approx(float(loss), rel=1e-5)
    assert outs[4][1]["loss"] == pytest.approx(float(metrics["loss"]),
                                               rel=1e-5)
    for (path, r), (_, p) in zip(leaves(jax.tree.map(np.asarray, grads)),
                                 leaves(outs[4][2])):
        assert rel(p, r) <= 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    rcfg, pcfg = cfgs(arch, "bfloat16")
    rm = ref_build(rcfg)
    pm = build_model(pcfg, device="cpu")
    for kind in ("train", "prefill", "decode"):
        r = rm.input_specs(RefShape("s", 32, 4, kind))
        p = pm.input_specs(ShapeConfig("s", 32, 4, kind))
        assert list(p) == list(r), kind
        for name, spec in p.items():
            if name == "cache":
                assert set(spec) == set(r[name])
                for k, s in spec.items():
                    assert tuple(s.shape) == tuple(r[name][k].shape), k
                continue
            assert tuple(spec.shape) == tuple(r[name].shape), (kind, name)
            assert spec.batch_axis == 0
            want = {"int32": torch.int64, "bfloat16": torch.bfloat16}
            assert spec.dtype == want[str(r[name].dtype)], (kind, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_both_ways(arch):
    """``params_to_jax`` gives back the reference's tree exactly (f32
    masters), and the serving build of it holds ``cfg.dtype``
    matrices."""
    tree = ref_params(arch)
    _, pcfg = cfgs(arch, "bfloat16")
    pp = params_from_jax(pcfg, tree, device="cpu", trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in pp.parameters())
    back = params_to_jax(pp)
    assert [p for p, _ in leaves(back)] == [p for p, _ in leaves(tree)]
    for (path, a), (_, b) in zip(leaves(back), leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    served = params_from_jax(pcfg, back, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert served.tok.embed.dtype == torch.bfloat16


def test_trainable_build_holds_f32_masters():
    _, pcfg = cfgs("tinyllama-1.1b", "bfloat16")
    m = build_model(pcfg, device="cpu", trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in m.params.parameters())
    fresh = m.init_params(1)
    assert fresh is not m.params
    assert not torch.equal(fresh.tok.embed, m.params.tok.embed)
    frozen = build_model(pcfg, device="cpu")
    assert frozen.params.layers[0].attn.wq.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in frozen.params.parameters())


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "llava-next-34b"))
def test_logits_fn_is_what_loss_fn_scores(arch):
    """``logits_fn`` gives the logits ``loss_fn`` scores: their cross
    entropy plus 0.01·aux is the loss."""
    from repro_torch.models.layers import cross_entropy
    from torch_train_parity import port_batch, port_model

    pcfg, pm, pp = port_model(arch, "float32")
    batch = port_batch(train_batch(pcfg))
    loss, metrics = pm.loss_fn(pp, batch)
    logits = pm.logits_fn(pp, batch)
    assert logits.shape == (4, 32, pcfg.padded_vocab)
    assert logits.dtype == torch.float32
    ce, _ = cross_entropy(logits, batch["labels"])
    assert float(ce) == float(metrics["loss"])
    assert float(loss) == pytest.approx(float(ce + 0.01 * metrics["aux"]),
                                        rel=1e-7)


def test_recording_follows_autograd():
    w = torch.ones(2, requires_grad=True)
    assert recording(w * 2)
    assert not recording(torch.ones(2) * 2)
    with torch.no_grad():
        assert not recording(w * 2)


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_refuse_inputs_that_require_grad(cuda_device):
    from repro_torch.kernels import attention as att
    from repro_torch.kernels.rwkv6 import rwkv6_forward
    from repro_torch.kernels.ssd import ssd_forward

    def g(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=cuda_device).to(dtype)
    q = g(1, 4, 64, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        att.flash_attention(q, g(1, 4, 64, 64), g(1, 4, 64, 64))
    pool = g(4, 8, 16, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        att.paged_attention(g(2, 4, 64), pool, g(4, 8, 16, 64),
                            torch.zeros((2, 4), dtype=torch.int32,
                                        device=cuda_device),
                            torch.ones(2, dtype=torch.int32,
                                       device=cuda_device))
    r = g(1, 2, 64, 64).requires_grad_()
    w = torch.rand((1, 2, 64, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        rwkv6_forward(r, g(1, 2, 64, 64), g(1, 2, 64, 64), w,
                      g(2, 64, dtype=torch.float32))
    x = g(1, 2, 64, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_forward(x, torch.rand((1, 2, 64), device=cuda_device),
                    g(2, dtype=torch.float32), g(1, 64, 16), g(1, 64, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_loss_and_grads_match_cpu_f32(cuda_device, arch):
    """The training route on the card (plain attention and
    recurrences, no kernel) against the CPU, in f32."""
    from repro_torch.kernels import fleet

    c_loss, _, c_g = port_loss_grads(arch, "float32")
    fleet.reset_launches()
    g_loss, _, g_g = port_loss_grads(arch, "float32", device=cuda_device)
    torch.cuda.synchronize()
    assert not any(fleet.LAUNCHES.values()), fleet.LAUNCHES
    assert g_loss == pytest.approx(c_loss, rel=1e-5)
    for (path, c), (_, g) in zip(leaves(c_g), leaves(g_g)):
        assert rel(g, c) <= 1e-4, path
