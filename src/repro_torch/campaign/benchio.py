"""Shared BENCH_torch*.json schema: one writer, one tolerant loader.

Every perf/VR trajectory the port persists at the root —
``BENCH_torchscale.json``, ``BENCH_torchserving.json``, the campaign
harness's own ``BENCH_torchcampaign.json`` and the other sections of
:mod:`repro_torch.benchmarks.run` — goes through :func:`bench_payload`
/ :func:`write_bench`, so they all share ONE schema, the reference's::

    {
      "schema_version": 1,
      "section": "<name>",
      "machine": {platform, python, cpus, numpy, torch, cpu_model,
                  [gpu_name, gpu_power_limit]},
      "written_at": "YYYY-MM-DDTHH:MM:SS",
      "rows": [...],
      ... optional section-specific extras ...
    }

:func:`load_bench` is the tolerant loader the campaign regression
differ (:mod:`repro_torch.campaign.diff`) reads baselines with: a missing
file, unparseable JSON, a payload without a ``rows`` list, or a
``schema_version`` outside the supported range all degrade to ``None``
("no baseline") instead of crashing the gate. Files written before the
``schema_version`` field existed carry the implicit version 0 and stay
loadable.

A section's file is ``BENCH_torch<section>.json``: the port never
writes, and never takes for its own baseline, a file of the reference
(``BENCH_<section>.json``).
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

#: current writer version. Bump ONLY on a breaking row/payload reshape;
#: the loader keeps accepting [MIN_SCHEMA_VERSION, SCHEMA_VERSION].
SCHEMA_VERSION = 1
#: oldest payload shape the loader still understands (0 = the implicit
#: pre-``schema_version`` files).
MIN_SCHEMA_VERSION = 0


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (a card below
    its maximum limit runs slower under load); ``torch`` names the card
    where ``nvidia-smi`` cannot be run."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
        name, limit = (x.strip() for x in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError):
        name, limit = torch.cuda.get_device_name(0), None
    return {"gpu_name": name, "gpu_power_limit": limit}


def machine_info() -> dict:
    """The host fingerprint stamped into every BENCH payload (walls are
    only comparable across runs when this matches): the host, and the
    card when CUDA is present."""
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpus": os.cpu_count(),
        "numpy": np.__version__,
        "torch": torch.__version__,
    }
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    info["cpu_model"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if torch.cuda.is_available():
        info.update(card_info())
    return info


def bench_payload(section: str, rows: list, **extra) -> dict:
    """The canonical BENCH payload for ``section`` (not yet written)."""
    payload = {
        "schema_version": SCHEMA_VERSION,
        "section": section,
        "machine": machine_info(),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "rows": rows,
    }
    payload.update(extra)
    return payload


def bench_path(section: str, root: str = ".") -> str:
    return os.path.join(root, f"BENCH_torch{section}.json")


def write_bench(section: str, rows: list, root: str = ".",
                quiet: bool = False, **extra) -> str:
    """Write ``BENCH_torch<section>.json`` under ``root`` and return
    its path."""
    payload = bench_payload(section, rows, **extra)
    path = bench_path(section, root)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
        f.write("\n")
    if not quiet:
        print(f"# wrote {path}", file=sys.stderr)
    return path


def load_bench(path: str) -> dict | None:
    """Tolerant baseline loader: returns the payload dict, or ``None``
    ("no baseline") when the file is missing, unparseable, not shaped
    like a BENCH payload, or written by an unsupported schema version.
    Never raises — a broken baseline must not break the gate that
    wants to diff against it."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    rows = payload.get("rows")
    if not isinstance(rows, list):
        return None
    version = payload.get("schema_version", 0)
    if not isinstance(version, int) or \
            not MIN_SCHEMA_VERSION <= version <= SCHEMA_VERSION:
        return None
    return payload


def load_section(section: str, root: str = ".") -> dict | None:
    """``load_bench`` by section name under ``root``."""
    return load_bench(bench_path(section, root))
