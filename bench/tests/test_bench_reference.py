"""The plain reference of each architecture against the port's plain
path at reduced widths, on the benchmark's weights handed to both; the
hybrid architecture is the fixture a later change would add
(``fixtures/hybrid``)."""
import json

import pytest
import torch

from bench import modules
from bench.reference import model as ref
from bench.reference import weights as bw
from bench.tests.small import DENSE, FIXTURE, HYBRID, MOE, ROOT


def _port_logits(c, w, toks, root):
    from repro_torch.models import build_model
    from repro_torch.serving.engine import prefill_batch
    arch = modules.program(c, root)
    m = build_model(arch.program_config(c), device="cpu")
    arch.hand_in(m.params, w, c)
    return m, m.prefill_fn(m.params, prefill_batch(m.cfg, toks[None]))


@pytest.mark.parametrize("name,arch,small,root", [
    ("olmoe-1b-7b", "decoder", MOE, ROOT),
    ("granite-8b", "decoder", DENSE, ROOT),
    ("zamba2-2.7b", "hybrid", HYBRID, FIXTURE)])
def test_prefill_and_decode_logits_equal_the_reference_in_f32(name, arch,
                                                             small, root):
    from repro_torch.models.kvcache import grow_cache
    cfg = json.loads((root / f"bench/configs/{name}.json").read_text())
    assert cfg["arch"] == arch
    c = {**cfg, **small, "torch_dtype": "float32"}
    w = bw.make(c, 7, "cpu", root)
    toks = torch.randint(0, c["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(1))
    m, (last, cache) = _port_logits(c, w, toks[:-3], root)
    r = modules.reference(c, root).logits_at(c, w, toks,
                                             torch.arange(36, 40))
    assert torch.allclose(last[0], r[0], atol=1e-5, rtol=1e-5)
    # decode three tokens through the caches (K5's plain version, and
    # the hybrid's Mamba-2 states)
    full = grow_cache(m.cfg, cache, 64)
    for j in range(3):
        pos = torch.tensor([37 + j])
        lg, full = m.decode_fn(m.params, full, toks[37 + j:38 + j], pos)
        assert torch.allclose(lg[0], r[1 + j], atol=1e-5, rtol=1e-5)


def test_fp8_control_departs_from_float32():
    cfg = json.loads((ROOT / "bench/configs/granite-8b.json").read_text())
    c = {**cfg, **DENSE}
    w = bw.make(c, 3, "cpu")
    toks = torch.arange(30) % c["vocab_size"]
    at = torch.arange(30)
    dec = modules.reference(c)
    a = dec.logits_at(c, w, toks, at)
    b = dec.logits_at(c, w, toks, at, mm=ref.fp8_mm)
    assert 1e-3 < float((a - b).abs().max()) < 0.5 * float(a.abs().max())


def test_weights_repeat_from_the_seed():
    cfg = json.loads((ROOT / "bench/configs/olmoe-1b-7b.json").read_text())
    c = {**cfg, **MOE}
    a, b, d = bw.make(c, 5, "cpu"), bw.make(c, 5, "cpu"), bw.make(c, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], d["wq"])
    assert a["w_gate"].dtype == torch.bfloat16
