"""The decoder architecture module changes no number: at the test size,
the benchmark's weights (a SHA-256 digest a leaf, seeds 5 and 7), the
reference's logits (plain and the fp8 control) and the per-layer
readings from one hand-built record equal those that the code before the
architecture modules gave on the same inputs (commit 08b9261; the values
are ``pinned_parent.json``). The digests hold for this torch's CPU
generator."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from bench import harness, modules
from bench.record import Record
from bench.reference import model as ref
from bench.reference import weights as bw
from bench.tests.small import DENSE, MOE, ROOT
from bench.tracing import Kernel, Trace

PINNED = json.loads((Path(__file__).parent / "pinned_parent.json")
                    .read_text())
CELLS = [("olmoe-1b-7b", MOE), ("granite-8b", DENSE)]
SEEDS = (5, 7)
READERS = ("flash_roofline", "paged_roofline", "mfu", "moe_roofline")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.contiguous().flatten().view(torch.uint8).numpy().tobytes()
    ).hexdigest()


def pinned_record(cfg: dict, **extra) -> Record:
    """A window [0, 9) traced from 6 s: prefills (one resumed) and decode
    steps of two tenants in the traced part, others before it and in the
    drain; K4, K5 and expert-product kernels launched inside and outside
    those calls."""
    rec = Record("c", cfg, (0.0, 9.0), 12.0, [],
                 steps=[(1.0, 1.3), (6.45, 6.8), (6.95, 7.2), (7.25, 7.5),
                        (9.4, 9.8)],
                 prefills=[(1.0, 1.2, "a", 1, 300, False),
                           (6.5, 6.7, "a", 2, 2000, False),
                           (6.72, 6.78, "b", 3, 517, True),
                           (9.5, 9.7, "a", 4, 700, False)],
                 decodes=[(2.0, 2.1, "a", [10, 20]),
                          (7.0, 7.1, "a", [2001, 37, 900]),
                          (7.3, 7.35, "b", [518]),
                          (10.0, 10.1, "a", [10, 20])],
                 rounds=[(3.0, 3.001), (8.0, 8.004)], **extra)
    kernels = [Kernel("flash_fwd_kernel", 6.62, 2.5e-3, 6.6),
               Kernel("flash_fwd_kernel", 6.75, 4e-4, 6.74),
               Kernel("paged_split_kernel", 7.06, 4e-4, 7.05),
               Kernel("paged_split_kernel", 7.32, 1e-4, 7.31),
               Kernel("nvjet_bmm", 6.64, 3e-2, 6.63),
               Kernel("other", 7.08, 5e-3, 7.07),
               Kernel("flash_fwd_kernel", 9.61, 1e-3, 9.6),
               Kernel("nvjet_bmm", 9.62, 3e-3, 9.61),
               Kernel("paged_split_kernel", 10.06, 1e-3, 10.05)]
    rec.trace = Trace(6.0, 9.0, kernels,
                      bmm_calls=[(6.625, 6.635), (9.605, 9.615)])
    return rec


def _config(name: str) -> dict:
    return json.loads((ROOT / f"bench/configs/{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,small", CELLS)
def test_weights_are_the_same_bytes(name, small, seed):
    w = bw.make({**_config(name), **small}, seed, "cpu")
    assert {k: digest(v) for k, v in w.items()} == \
        PINNED[name]["weights"][str(seed)]


@pytest.mark.parametrize("name,small", CELLS)
def test_reference_logits_are_the_same(name, small):
    c = {**_config(name), **small}
    w = bw.make(c, 7, "cpu")
    toks = torch.randint(0, c["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(1))
    at = torch.arange(30, 40)
    dec = modules.reference(c)
    assert digest(dec.logits_at(c, w, toks, at)) == \
        PINNED[name]["logits"]["plain"]
    assert digest(dec.logits_at(c, w, toks, at, mm=ref.fp8_mm)) == \
        PINNED[name]["logits"]["fp8"]


@pytest.mark.parametrize("name", [n for n, _ in CELLS])
def test_readers_read_the_same_values(name):
    cfg = _config(name)
    rec = pinned_record(cfg, arch=modules.program(cfg))
    got = {m: harness.load_metric(ROOT, m)(rec) for m in READERS}
    assert got == PINNED[name]["readers"]
