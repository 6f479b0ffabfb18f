"""Dry-run sweep: every (arch × shape × mesh) cell → JSON (the JAX
package's ``launch/sweep.py``).

Sequential; resumable (skips existing JSONs). Host-only, like
:mod:`repro_torch.launch.dryrun`.

  PYTHONPATH=src python -m repro_torch.launch.sweep \\
      --out results/torch_dryrun [--mesh both]

Cost control on the host:
  * the stacks in ``EXTRAPOLATE`` — the reference's four (arctic-480b,
    llava-next-34b, granite-8b, zamba2-2.7b) and rwkv6-3b, whose plain
    recurrence is a loop of one step a token, 4,096 or 32,768 a layer
    (the reference's ``lax.scan``, which its cost analysis counts once)
    — extrapolate linearly in depth from two shallow runs (terms are
    affine in L: embed/lm-head intercept + per-layer slope), tagged
    "extrapolated" in the table;
  * multi-pod cells run with scan_layers=True, as the reference's do:
    that pass proves the ("pod","data","model") sharding is coherent,
    not the roofline numbers. The port's layers are a loop either way.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable

EXTRAPOLATE = {"arctic-480b": (4, 8), "llava-next-34b": (4, 8),
               "granite-8b": (6, 12), "zamba2-2.7b": (6, 12),
               "rwkv6-3b": (1, 2)}
_LINEAR_KEYS = ("hlo_flops", "hlo_bytes")


def _extrapolate(arch, shape_name, multi_pod, L1, L2):
    from repro_torch.launch.dryrun import run_cell
    cfg = get_config(arch)
    L_full = cfg.num_layers

    def with_layers(L):
        ov = {"num_layers": L}
        if cfg.attn_every:
            ov["num_layers"] = max(L // cfg.attn_every, 1) * cfg.attn_every
        if cfg.is_encoder_decoder:
            ov["num_encoder_layers"] = L
        return run_cell(arch, shape_name, multi_pod, overrides=ov,
                        extra={"layers_used": ov["num_layers"]})

    r1 = with_layers(L1)
    if r1["status"] != "ok":
        return r1
    r2 = with_layers(L2)
    if r2["status"] != "ok":
        return r2
    l1, l2 = r1["layers_used"], r2["layers_used"]
    out = dict(r2)
    out["tag"] = "extrapolated"
    out["extrapolated_from"] = [l1, l2]

    def lin(v1, v2):
        slope = (v2 - v1) / (l2 - l1)
        return v1 + slope * (L_full - l1)

    for k in _LINEAR_KEYS:
        out[k] = lin(r1[k], r2[k])
    wire = lin(r1["collectives"]["wire_bytes_per_chip"],
               r2["collectives"]["wire_bytes_per_chip"])
    out["collectives"] = {"wire_bytes_per_chip": wire,
                          "ops": r2["collectives"]["ops"],
                          "note": f"ops listed for L={l2}; totals extrapolated"}
    from repro_torch.launch.dryrun import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           model_flops)
    mf = model_flops(get_config(arch), SHAPES[shape_name])
    n_chips = out["n_chips"]
    terms = {"compute_s": out["hlo_flops"] / PEAK_FLOPS,
             "memory_s": out["hlo_bytes"] / HBM_BW,
             "collective_s": wire / LINK_BW}
    out.update(terms)
    out["model_flops"] = mf
    out["model_flops_per_chip"] = mf / n_chips
    out["useful_flops_frac"] = (mf / n_chips) / out["hlo_flops"]
    out["dominant"] = max(terms, key=terms.get)
    out["step_time_lb_s"] = max(terms.values())
    out["roofline_frac"] = (mf / n_chips / PEAK_FLOPS) / max(terms.values())
    return out


def run_one(arch, shape_name, mesh_kind, out_dir, tag="baseline"):
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}__{tag}.json")
    if os.path.exists(fname):
        return "cached"
    from repro_torch.launch.dryrun import run_cell
    multi = mesh_kind == "multi"
    t0 = time.time()
    try:
        if multi:
            # coherence pass
            res = run_cell(arch, shape_name, True,
                           overrides={"scan_layers": True},
                           extra={"tag": tag, "mode": "scan"})
        elif arch in EXTRAPOLATE:
            res = _extrapolate(arch, shape_name, False, *EXTRAPOLATE[arch])
        else:
            res = run_cell(arch, shape_name, False, extra={"tag": tag})
    except Exception as e:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-3000:], "tag": tag}
    res["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    with open(fname, "w") as f:
        json.dump(res, f, indent=2, default=str)
    return res["status"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated subset")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
    # cheap decode cells first (fast feedback), then prefill, then train
    order = {"decode_32k": 0, "long_500k": 1, "prefill_32k": 2, "train_4k": 3}
    shapes.sort(key=lambda s: order.get(s, 9))

    total = 0
    for mesh_kind in meshes:
        for shape_name in shapes:
            for arch in archs:
                # a cell that does not apply records its skip explicitly
                status = run_one(arch, shape_name, mesh_kind, args.out)
                total += 1
                print(f"[{total}] {mesh_kind:6s} {shape_name:12s} "
                      f"{arch:18s} -> {status}", flush=True)


if __name__ == "__main__":
    main()
