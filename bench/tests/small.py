"""Cells cut to a size the CPU runs in seconds, for the tests: the cell's
own code path and files, with reduced widths and short traffic."""
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DENSE = {"num_hidden_layers": 2, "hidden_size": 512,
         "intermediate_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 500}
MOE = {**DENSE, "num_key_value_heads": 4, "num_experts": 8,
       "num_experts_per_tok": 2}
#: the hybrid fixture (``fixtures/hybrid``): two groups of one shared
#: attention block and two Mamba-2 layers of 16 heads of 16, state 16
HYBRID = {**DENSE, "num_hidden_layers": 4, "attn_every": 2,
          "hidden_size": 128, "mamba_d_state": 16, "mamba_headdim": 16,
          "mamba_expand": 2}
#: the files a later change adds for a new architecture (the hybrid
#: family), laid out as in a checkout: ``<FIXTURE>/bench/...``
FIXTURE = ROOT / "bench" / "tests" / "fixtures" / "hybrid"
TRAFFIC = {
    "rate_per_s": 4.0, "warmup_s": 1.0, "drain_limit_s": 5.0,
    "prompt": {"median": 48, "sigma": 0.5, "min": 16, "max": 96},
    "answer": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
    "engine": {"page_size": 16, "slot_cap": 4, "max_seq_len": 128,
               "round_interval_steps": 10, "policy": "sdps",
               "capacity_slots": 6, "capacity_pages": 48,
               "default_units": 3},
    "tenants": [{"name": "a", "share": 0.5, "slo_s": 0.5, "premium": 1.0,
                 "min_units": 3, "max_units": 3},
                {"name": "b", "share": 0.5, "slo_s": 1.0, "premium": 0.0,
                 "min_units": 3, "max_units": 3}]}


def run(cell: str, seed: int, *, cfg=DENSE, fault=None, control=False,
        root: Path = ROOT, seconds: float = 3.0, **traffic):
    """One CPU run of ``cell`` at the test size; the cell's own ``check``
    (its limit) is kept."""
    import torch

    from bench import harness
    torch.set_num_threads(2)
    return harness.run(root, cell, seed, seconds, False,
                       t_start=time.perf_counter(), device="cpu",
                       cfg_over=cfg, traffic_over={**TRAFFIC, **traffic},
                       fault=fault, control=control)
