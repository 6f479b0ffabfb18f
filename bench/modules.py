"""Modules the benchmark finds by name, loaded by path from a checkout's
``bench/`` folder, so that a later change adds one as a new file:

- ``metrics/<name>.py``: the reader of per-layer metric ``name``;
- ``arch/<arch>.py`` and ``reference/<arch>.py``: the two modules of the
  architecture that a configuration file names under ``"arch"``. The
  first is the program's side (its ``ModelConfig``, the hand-over of the
  benchmark's weights, the FLOPs that ``mfu`` counts and the layers that
  run K4/K5); the second is the weight layout and the plain reference,
  which import nothing of the program."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

#: the checkout this package lies in, where no other root is given
ROOT = Path(__file__).resolve().parents[1]

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]*")


def load(path: Path, name: str):
    """The module in the file ``path``, executed afresh as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program(cfg: dict, root: Path | None = None):
    """The program's side of ``cfg``'s architecture: ``bench/arch/<arch>.py``."""
    return _arch(cfg, root, "arch")


def reference(cfg: dict, root: Path | None = None):
    """The weight layout and plain reference of ``cfg``'s architecture:
    ``bench/reference/<arch>.py``."""
    return _arch(cfg, root, "reference")


def _arch(cfg: dict, root: Path | None, folder: str):
    name = cfg.get("name")
    arch = cfg.get("arch")
    if arch is None:
        raise SystemExit(f"configuration {name!r} has no \"arch\" key: it "
                         "names the architecture's modules, bench/arch/"
                         "<arch>.py and bench/reference/<arch>.py")
    rel = f"bench/{folder}/{arch}.py"
    path = (root or ROOT) / rel
    if not (isinstance(arch, str) and _NAME.fullmatch(arch)
            and path.is_file()):
        raise SystemExit(f"configuration {name!r}: its \"arch\" {arch!r} "
                         f"names no module {rel}")
    return load(path, f"bench.{folder}.{arch}")
