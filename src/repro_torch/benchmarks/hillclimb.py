"""§Perf hillclimb runner: the three selected cells, baseline vs staged
optimisations (the JAX package's ``benchmarks/hillclimb.py`` on the
port's dry-run). Each run re-builds and re-accounts one step and records
the three roofline terms; results land in results/torch_hillclimb/.
Host-only.

  PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb [--cell A|B|C]

Cells (selection rule: worst roofline fraction / most collective-bound /
most representative of the paper's technique):
  A olmoe-1b-7b  × train_4k   — MoE dispatch pathology (collective)
  B granite-8b   × train_4k   — dense-train memory/collective
  C granite-8b   × decode_32k — multi-tenant decode (the DYVERSE step)

granite cells run at a fixed L=12 so before/after compare the same
program family; the full-depth numbers in §Roofline extrapolate. The
hypotheses are the reference's, verbatim: they name its XLA and TPU
mechanisms, and the port's numbers test them on its own program.
"""
from __future__ import annotations

import argparse
import json
import os
import time

OUT = "results/torch_hillclimb"

# (cell, arch, shape, tag, overrides, hypothesis)
RUNS = [
    # ---------------- Cell A: olmoe train_4k ----------------
    ("A", "olmoe-1b-7b", "train_4k", "baseline", {},
     "EP dispatch: global argsort/scatter over (T×data, E×model) forces "
     "GSPMD to reshard the (E·C,D) buffers; top-8 moves every token 8x. "
     "Predict collective term O(100s)."),
    ("A", "olmoe-1b-7b", "train_4k", "opt1_moe_tp",
     {"moe_strategy": "tp"},
     "TP-experts via shard_map: dispatch stays data-local; only the "
     "F-contraction partial-sum crosses 'model'. Napkin: wire drops from "
     "~T_l*k*D*multiple to ~E*C_l*D per layer -> expect >=10x less "
     "collective."),
    ("A", "olmoe-1b-7b", "train_4k", "opt2_moe_tp_bf16",
     {"moe_strategy": "tp", "bf16_reduce": True},
     "Boundary reductions in bf16 halve the remaining attention-side "
     "all-reduce payload (f32->bf16). Predict ~1.3-2x on collective."),
    ("A", "olmoe-1b-7b", "train_4k", "opt3_tp_bf16_sp",
     {"moe_strategy": "tp", "bf16_reduce": True, "seq_parallel": True},
     "Megatron-SP residual stream: AR -> RS+AG halves wire for the "
     "non-MoE blocks and shrinks norm/residual HBM traffic 16x. Predict "
     "memory term down ~>=20%."),
    ("A", "olmoe-1b-7b", "train_4k", "opt4_tp_late_psum",
     {"moe_strategy": "tp"},
     "ROUND 2 (after code change): fully-manual shard_map — scatter-"
     "combine BEFORE the reduction (scatter commutes with psum), so the "
     "per-layer collective is ONE AR of (T_l,D)≈0.27GB instead of the "
     "(E*C_l,D)≈2.7GB partial buffer. Predict collective 14.3s -> ~2s."),
    # ---------------- Cell B: granite train_4k ----------------
    ("B", "granite-8b", "train_4k", "baseline", {"num_layers": 12},
     "Dense TP=16 training pays 4 activation ARs/layer, some deferred "
     "into f32; memory term dominated by f32 attention chunk logits + "
     "norm traffic."),
    ("B", "granite-8b", "train_4k", "opt1_bf16",
     {"num_layers": 12, "bf16_reduce": True},
     "Materialise row-parallel sums in bf16 at block boundary: halves "
     "those AR payloads (f32->bf16). Predict collective down ~25-40%."),
    ("B", "granite-8b", "train_4k", "opt2_bf16_sp",
     {"num_layers": 12, "bf16_reduce": True, "seq_parallel": True},
     "SP: sequence-sharded residual stream between blocks; AR->RS+AG "
     "(half wire) and 16x less norm/residual HBM traffic. Predict "
     "collective down ~2x on top, memory down 10-20%."),
    ("B", "granite-8b", "train_4k", "opt3_sp_remat_none",
     {"num_layers": 12, "bf16_reduce": True, "seq_parallel": True,
      "remat": "none"},
     "Remat off: useful_flops_frac -> ~1 (no recompute) at the cost of "
     "saved-activation traffic; on v5e HBM this trades compute for "
     "memory — measure which term moves."),
    ("B", "granite-8b", "train_4k", "opt4_sp_bf16probs",
     {"num_layers": 12, "bf16_reduce": True, "seq_parallel": True,
      "remat": "none", "attn_bf16_probs": True},
     "ROUND 2: PV matmul reads bf16 probabilities (f32 accumulators "
     "kept). The (B,H,S,chunk) prob buffers are the largest attention "
     "traffic; halving their width should cut the memory term ~10-20%."),
    # ---------------- Cell C: granite decode_32k ----------------
    ("C", "granite-8b", "decode_32k", "baseline", {"num_layers": 12},
     "Cache is seq-sharded (kv=8 < model=16) but q is head-sharded: "
     "GSPMD reshards ~the whole cache per step (~GBs)."),
    ("C", "granite-8b", "decode_32k", "opt1_partials",
     {"num_layers": 12, "decode_partials": True},
     "Flash-decoding: keep logits seq-sharded, combine only (B,H,D) "
     "partials + softmax stats across 'model'. Napkin: per-layer "
     "collective drops from O(cache/16) to O(B*H*D) ~ few MB -> expect "
     ">=10x less collective."),
    ("C", "granite-8b", "decode_32k", "opt2_partials_bf16",
     {"num_layers": 12, "decode_partials": True, "bf16_reduce": True},
     "bf16 boundary sums for the tiny per-token activations too."),
    ("C", "granite-8b", "decode_32k", "opt3_grouped",
     {"num_layers": 12, "decode_partials": True, "decode_grouped": True},
     "ROUND 2: KH-grouped decode einsums — never materialise the "
     "(B,S,H,D) repeat_kv; cache is read at native KH width. Memory term "
     "should approach pure param+cache streaming (predict ~2-3x down; "
     "the Pallas paged_attention kernel realises the same on real TPU)."),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=["A", "B", "C"])
    ap.add_argument("--tags", default=None, help="comma list to (re)run")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_cell
    os.makedirs(OUT, exist_ok=True)
    tags = set(args.tags.split(",")) if args.tags else None

    for cell, arch, shape, tag, ov, hyp in RUNS:
        if args.cell and cell != args.cell:
            continue
        if tags and tag not in tags:
            continue
        fname = f"{OUT}/{cell}__{arch}__{shape}__{tag}.json"
        if os.path.exists(fname):
            print(f"[{cell}/{tag}] cached")
            continue
        t0 = time.time()
        try:
            res = run_cell(arch, shape, False, overrides=ov,
                           extra={"tag": tag, "cell": cell,
                                  "hypothesis": hyp})
        except Exception as e:
            import traceback
            res = {"cell": cell, "arch": arch, "shape": shape, "tag": tag,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-3000:]}
        res["wall_s"] = round(time.time() - t0, 1)
        with open(fname, "w") as f:
            json.dump(res, f, indent=2, default=str)
        if res["status"] == "ok":
            print(f"[{cell}/{tag}] compute={res['compute_s']:.4g}s "
                  f"memory={res['memory_s']:.4g}s "
                  f"collective={res['collective_s']:.4g}s "
                  f"dominant={res['dominant']}", flush=True)
        else:
            print(f"[{cell}/{tag}] ERROR {res.get('error', '')[:100]}",
                  flush=True)


def report():
    import glob
    rows = []
    for p in sorted(glob.glob(f"{OUT}/*.json")):
        with open(p) as f:
            rows.append(json.load(f))
    by_cell: dict[str, list] = {}
    for r in rows:
        by_cell.setdefault(r.get("cell", "?"), []).append(r)
    lines = []
    for cell in sorted(by_cell):
        rs = by_cell[cell]
        base = next((r for r in rs if r["tag"] == "baseline"), None)
        lines.append(f"\n### Cell {cell}: {rs[0]['arch']} × {rs[0]['shape']}")
        lines.append("| tag | compute_s | memory_s | collective_s | dominant "
                     "| Δdominant vs baseline |")
        lines.append("|---|---|---|---|---|---|")
        for r in rs:
            if r.get("status") != "ok":
                lines.append(f"| {r['tag']} | ERROR {r.get('error','')[:60]} |||||")
                continue
            delta = ""
            if base and base.get("status") == "ok":
                d0 = base[base["dominant"]]
                d1 = r[base["dominant"]]
                delta = f"{(1 - d1 / d0) * 100:+.1f}%" if d0 else ""
            lines.append(
                f"| {r['tag']} | {r['compute_s']:.4g} | {r['memory_s']:.4g} "
                f"| {r['collective_s']:.4g} | {r['dominant']} | {delta} |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
    print(report())
