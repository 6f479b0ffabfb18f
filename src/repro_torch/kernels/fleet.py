"""The fleet engine's GPU kernels, each beside its plain torch version.

Three CUDA kernels carry ``engine="torch"`` (sources in
``repro_torch/csrc/``, built with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at first use and bound with ``ctypes``):

========== ============================== ===================================
kernel     replaces (JAX package)         bound on an H100
========== ============================== ===================================
K1         ``_scale_kernel`` /            bytes: one f32 read and one f32
latency_   ``_pallas_latency_scale``      write per (tenant, second) cell
scale      (Pallas, jax_backend.py)       (then the division and powf)
K2         ``_dense_impl``,               issue rate: ~74 int32 ops a cell
row_draw   ``_fused_impl``,               for the 20 threefry rounds, 31
           ``_jitter_impl`` (jit bodies)  float ones
K3         ``_poisson_impl``              f64 pipe: 6 instructions a search
poisson    (jax.random.poisson)           step, ~lam steps a cell, and 16
                                          a set-up (u and exp(-lam))
========== ============================== ===================================

Every wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises (no fallback). Each
launch adds one to :data:`LAUNCHES` (and K2's to its mode in
:data:`ROW_DRAW_MODES`), so a run can show that it went through the
kernels.

The build and launch machinery here (nvcc at first use, ctypes, the
launch counts) also serves the attention kernels K4 and K5 of
:mod:`repro_torch.kernels.attention` and the recurrent kernels K6
(:mod:`repro_torch.kernels.rwkv6`) and K7 (:mod:`repro_torch.kernels.ssd`).

Random bits: ``threefry2x32`` with 20 rounds, JAX's partitionable
scheme (key ``(k0, k1)``, counter ``(hi, lo)``, bits ``x0 ^ x1``). The
plain versions compute the same words with int64 tensors masked to 32
bits (``torch.uint32`` lacks ops on the CPU), so a kernel and its plain
version draw identical bits, and both reproduce ``jax.random.normal``'s
uniforms bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

LAUNCHES = {"latency_scale": 0, "row_draw": 0, "poisson": 0,
            "flash_attention": 0, "paged_attention": 0, "rwkv6": 0,
            "ssd": 0}
#: K2's launches by mode, and by mode and "rows x cols" shape
ROW_DRAW_MODES = {"dense": 0, "fused": 0, "jitter": 0}
ROW_DRAW_SHAPES: dict[str, dict[str, int]] = {m: {} for m in ROW_DRAW_MODES}

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal's uniform range: [nextafter(-1, 0), 1) in float32
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
_SPAN = np.float32(1.0) - _LO
_SQRT2 = np.float32(np.sqrt(2.0))
_MODES = {"dense": 0, "fused": 1, "jitter": 2}

POISSON_INVERSION_MAX_LAM = 100.0
_POISSON_MAX_K = 10000
_POISSON_MAX_ATTEMPTS = 1000

# ------------------------------------------------------------ the card
#: H100 SXM rates (NVIDIA's data sheet): 3.35 TB/s of HBM3; 67 TFLOP/s
#: float32 outside the tensor cores, i.e. 128 lanes per SM per clock
#: over 132 SMs with an FMA counted as two. An SM issues one warp
#: instruction per clock on each of its four partitions, so 33.5e12
#: 32-bit lane operations a second, integer or float, is the most any
#: mix can reach (integer adds issue on the FMA pipe as IMAD, logic and
#: shifts on the ALU pipe). 34 TFLOP/s float64, i.e. 17e12 lane ops.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12 / 2
F64_OPS_PER_S = 34e12 / 2
#: operations a cell, counted from the kernel sources (one per
#: arithmetic instruction: threefry is 60 round ops, 10 key injections,
#: 1 counter add, the xor and the shift/or of the mantissa; erfinvf and
#: expf are counted at their inlined instruction length)
THREEFRY_INT_OPS = 74
ROW_DRAW_F32_OPS = 31
#: K1 a cell, the instructions of its common path in the kernel's SASS
#: (``cuobjdump -sass``): the IEEE f32 division (reciprocal, five FFMA,
#: the range check, its branch and reconvergence: 10), max, compare,
#: branch and reconvergence (6), the product (1); powf's inlined path on
#: the cells where rho > 1 (78)
LATENCY_SCALE_F32_OPS = 17
POWF_F32_OPS = 78
#: the integer ALU pipe (LOP3, SHF, IADD3, ISETP, ...) takes 16 lanes a
#: clock on each of an SM's four partitions, half the issue rate
ALU_OPS_PER_S = LANE_OPS_PER_S / 2
#: K3, (f64-pipe, ALU-pipe) instructions of a search step and of a cell's
#: set-up, counted in the SASS of ``poisson_kernel`` (``cuobjdump -sass``;
#: chip_smoke.py's env phase counts them again and fails where they
#: differ). A step is the search block's 96 f64 (k + 1, p·lam, the
#: product by RN(1/k), two FMAs, F + p) and 58 ALU (the compare u > F,
#: the count, the flag) over its 16 steps; a set-up is the block of
#: threefry's 20 rounds interleaved with exp(-lam): 16 f64, 53 ALU. The
#: kernel's other instructions (table loads, moves, votes, branches) are
#: not the function's work and are not counted.
POISSON_STEP_OPS = (6, 58 / 16)
POISSON_SETUP_OPS = (16, 53)


# ------------------------------------------------------------- devices
def check_device(device) -> torch.device:
    """The torch device an entry point was asked for; raises when that
    is a CUDA device and none is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain torch versions")
    return dev


# ---------------------------------------------------------------- build
_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("latency_scale", "row_draw", "poisson", "flash_attention",
            "paged_attention", "rwkv6", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: sources built with unfused multiply-adds: K1-K3's bit-exactness to
#: JAX's threefry and latency scale rests on it; the attention and the
#: recurrent kernels (held to their plain versions run in f64) fuse freely
_NO_FMAD = ("latency_scale", "row_draw", "poisson")


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags of one source (without ``-Xptxas -v``)."""
    return NVCC_FLAGS + (("-fmad=false",) if name in _NO_FMAD else ())


_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's output per source from the last verbose build
BUILD_LOGS: dict[str, str] = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = {
    "latency_scale_f32": [_P, _P, _P, _P, _P, _I64, _I64, _P],
    "row_draw_f32": [ctypes.c_int, _P, _P, ctypes.c_uint, _P, _P, _P, _P,
                     _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                     ctypes.c_float, _INT, _INT, _I64, _INT, _INT, _P],
    "poisson_i32": [_P, _P, ctypes.c_uint, _P, _P, _I64, _I64, _P],
    "flash_attention_fwd": [_INT, _INT, _P, _P, _P, _P, _INT, _INT, _INT,
                            _INT, _INT, _P, _INT, _INT, ctypes.c_float, _P],
    "paged_attention_fwd": [_INT, _INT, _P, _P, _P, _P, _P, _P, _INT, _INT,
                            _INT, _INT, _INT, _P, ctypes.c_float, _INT, _P,
                            _P, _P],
    "rwkv6_fwd": [_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT,
                  _INT, _P, _P, _P],
    "ssd_fwd": [_INT, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT,
                _INT, _INT, _P, _P, _P],
}
_ENTRY = {"latency_scale": "latency_scale_f32", "row_draw": "row_draw_f32",
          "poisson": "poisson_i32", "flash_attention": "flash_attention_fwd",
          "paged_attention": "paged_attention_fwd", "rwkv6": "rwkv6_fwd",
          "ssd": "ssd_fwd"}


def build_dir() -> Path:
    """Where the shared libraries go: ``$REPRO_TORCH_BUILD_DIR``, else
    ``build/repro_torch`` beside ``src/`` in the checkout."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the kernels are compiled at first "
                       "use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    # ``-Xptxas -v`` only reports, so a verbose build makes the same
    # library: a later plain build (a campaign's child) finds it
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for f in [_SRC_DIR / f"{name}.cu", *sorted(_SRC_DIR.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=_SOURCES, verbose: bool = False) -> float:
    """Compile the named kernels (all ``nvcc`` processes started
    together) and load them; returns the wall seconds. Libraries are
    keyed by a hash of their sources and flags, so a rebuilt tree never
    loads a stale one. ``verbose`` adds ``-Xptxas -v``, prints what the
    assembler reports (registers, spills) and keeps it in
    :data:`BUILD_LOGS` and beside the library, where a later verbose
    build that finds the library reads it again (and rebuilds one that
    a plain build made, which has no such report)."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        path = _lib_path(name)
        log_path = path.with_suffix(".log")
        if path.exists() and not (verbose and not log_path.exists()):
            if verbose:
                BUILD_LOGS[name] = log_path.read_text()
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), *extra, "-I", str(_SRC_DIR),
               "-o", str(tmp), str(_SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            BUILD_LOGS[name] = log
            print(f"[nvcc {name}]\n{log}")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            if verbose:
                path.with_suffix(".log").write_text(log)
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, _ENTRY[name])
            fn.argtypes = _ARGTYPES[_ENTRY[name]]
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return time.perf_counter() - t0


def _launch(name: str, *args) -> None:
    if name not in _LIBS:
        build((name,))
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_LIBS[name], _ENTRY[name])(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for m in ROW_DRAW_MODES:
        ROW_DRAW_MODES[m] = 0
        ROW_DRAW_SHAPES[m].clear()


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (all on one device, contiguous); False for
    CPU tensors; raises on anything else."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("fleet kernels take contiguous tensors")
    return True


def _check(t, dtype, shape, what):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ threefry
def threefry_bits(k0: torch.Tensor, k1: torch.Tensor, c0, c1) -> torch.Tensor:
    """``x0 ^ x1`` of threefry2x32-20 on int64 tensors holding 32-bit
    words (broadcasting); the plain twin of ``threefry2x32_xor`` in
    ``csrc/threefry.cuh``."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0 ^ x1


def _row_keys(k0, k1, chunk_word: int):
    """(rows, 1) int64 key words: int32 storage → unsigned 32-bit."""
    return ((k0.to(torch.int64) & _M32)[:, None],
            ((k1.to(torch.int64) & _M32) ^ (int(chunk_word) & _M32))[:, None])


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 N(0, 1) from 32 random bits exactly as jax.random.normal
    maps them: mantissa trick → [0, 1), affine onto [lo, 1), clamp,
    sqrt(2)·erfinv."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo, span, sqrt2 = (torch.tensor(float(c), dtype=torch.float32,
                                    device=bits.device)
                       for c in (_LO, _SPAN, _SQRT2))
    return sqrt2 * torch.erfinv(torch.maximum(lo, f * span + lo))


def _uniform_open01(bits: torch.Tensor) -> torch.Tensor:
    return (bits.to(torch.float64) + 0.5) * 2.0 ** -32


# ------------------------------------------------------- K1 latency scale
def latency_scale_plain(base_pf, alpha, demand, capacity) -> torch.Tensor:
    rho = demand / capacity[:, None]
    m = torch.clamp(rho, min=1.0)
    powed = torch.where(m > 1.0, torch.pow(m, alpha[:, None]),
                        torch.ones((), dtype=m.dtype, device=m.device))
    return base_pf[:, None] * powed


def latency_scale(base_pf: torch.Tensor, alpha: torch.Tensor,
                  demand: torch.Tensor, capacity: torch.Tensor
                  ) -> torch.Tensor:
    """K1: ``base_pf·max(1, demand/capacity)^alpha``, float32, shape of
    ``demand`` (T, W); the per-tenant vectors are (T,)."""
    T, W = demand.shape
    for t, what in ((base_pf, "base_pf"), (alpha, "alpha"),
                    (capacity, "capacity")):
        _check(t, torch.float32, (T,), what)
    _check(demand, torch.float32, (T, W), "demand")
    if not _on_cuda(base_pf, alpha, demand, capacity):
        return latency_scale_plain(base_pf, alpha, demand, capacity)
    out = torch.empty_like(demand)
    _launch("latency_scale", _ptr(base_pf), _ptr(alpha), _ptr(demand),
            _ptr(capacity), _ptr(out), T, W)
    return out


def latency_scale_bound_terms(T: int, W: int, pow_cells: int
                              ) -> tuple[float, float]:
    """K1's two least times for one (T, W) call, in ms: its bytes over
    the HBM rate and its f32 operations over the issue rate, with
    ``pow_cells`` of the cells (those with rho > 1 in this call's data)
    running powf."""
    t_bytes = 4 * (2 * T * W + 3 * T) / HBM_BYTES_PER_S
    t_ops = (T * W * LATENCY_SCALE_F32_OPS
             + pow_cells * POWF_F32_OPS) / LANE_OPS_PER_S
    return 1e3 * t_bytes, 1e3 * t_ops


def latency_scale_bound_ms(T: int, W: int, pow_cells: int
                           ) -> tuple[float, str]:
    """Least time for one (T, W) call: the larger of the two terms."""
    t_bytes, t_ops = latency_scale_bound_terms(T, W, pow_cells)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------- K2 row draw
def row_draw_plain(mode, k0, k1, chunk_word, cols, scale=None, sigma=None,
                   slo=None, active=None, totals=None):
    key0, key1 = _row_keys(k0, k1, chunk_word)
    col = torch.arange(cols, dtype=torch.int64, device=k0.device)[None, :]
    z = normal_from_bits(threefry_bits(key0, key1, 0, col))
    e = torch.exp(z * sigma[:, None])
    if mode == "jitter":
        return e
    lat = scale[:, None] * e
    mask = active if mode == "dense" else col < totals[:, None]
    viol = mask & (lat > slo[:, None])
    lat_sum = torch.where(mask, lat, torch.zeros((), device=lat.device)
                          ).sum(dim=1)
    return lat, viol, lat_sum, viol.sum(dim=1, dtype=torch.int32)


class RowDrawLayout(NamedTuple):
    """How K2 lays rows out on the card. Rows of at most ``short_max``
    columns take one warp each, ``short_warps`` rows a CTA and
    ``short_v`` consecutive columns a lane, on a persistent grid; longer
    rows take a CTA of ``wide_warps`` warps each and ``wide_v`` columns
    a thread. V is 2 or 4; a CTA has at most 16 warps."""
    short_v: int = 4
    short_warps: int = 4
    short_max: int = 512
    wide_v: int = 4
    wide_warps: int = 4

    def check(self) -> None:
        if self.short_v not in (2, 4) or self.wide_v not in (2, 4):
            raise ValueError(f"row_draw layout {self}: V is 2 or 4")
        if not (1 <= self.short_warps <= 16 and 1 <= self.wide_warps <= 16):
            raise ValueError(f"row_draw layout {self}: 1 to 16 warps a CTA")


#: the layout the sweep in chip_smoke.py's kernels phase found fastest
ROW_DRAW_LAYOUT = RowDrawLayout()


def row_draw(mode: str, k0: torch.Tensor, k1: torch.Tensor,
             chunk_word: int, *, cols: int | None = None,
             sigma: torch.Tensor, scale: torch.Tensor | None = None,
             slo: torch.Tensor | None = None,
             active: torch.Tensor | None = None,
             totals: torch.Tensor | None = None,
             layout: RowDrawLayout = ROW_DRAW_LAYOUT):
    """K2: per row, ``cols`` N(0,1) draws from the row's threefry key
    ``(k0, k1 ^ chunk_word)`` at counters ``(0, col)``.

    * ``"dense"`` — mask ``active`` (rows, cols) bool;
    * ``"fused"`` — mask ``col < totals[row]`` (int32);
    * ``"jitter"`` — returns ``exp(sigma·z)`` (rows, cols) only.

    Dense and fused return ``(lat, viol, lat_sum, viol_count)``:
    ``lat = scale·exp(sigma·z)`` f32, ``viol = mask & (lat > slo)``, the
    masked f32 row sum and the int32 row count. ``k0``/``k1`` are int32
    tensors holding the unsigned key words. ``layout`` changes only how
    the kernel spreads the work and the order of the row sums."""
    if mode not in _MODES:
        raise ValueError(f"row_draw mode {mode!r} not in {tuple(_MODES)}")
    layout.check()
    rows = k0.shape[0]
    if mode == "dense":
        cols = active.shape[1]
        _check(active, torch.bool, (rows, cols), "active")
    elif mode == "fused":
        _check(totals, torch.int32, (rows,), "totals")
    _check(k0, torch.int32, (rows,), "k0")
    _check(k1, torch.int32, (rows,), "k1")
    _check(sigma, torch.float32, (rows,), "sigma")
    if mode != "jitter":
        _check(scale, torch.float32, (rows,), "scale")
        _check(slo, torch.float32, (rows,), "slo")
    if not _on_cuda(k0, k1, sigma, scale, slo, active, totals):
        return row_draw_plain(mode, k0, k1, chunk_word, cols, scale, sigma,
                              slo, active, totals)
    dev = k0.device
    lat = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    if mode == "jitter":
        viol = lat_sum = count = None
    else:
        viol = torch.empty((rows, cols), dtype=torch.bool, device=dev)
        lat_sum = torch.empty(rows, dtype=torch.float32, device=dev)
        count = torch.empty(rows, dtype=torch.int32, device=dev)
    _launch("row_draw", _MODES[mode], _ptr(k0), _ptr(k1),
            int(chunk_word) & _M32, _ptr(active), _ptr(totals), _ptr(scale),
            _ptr(sigma), _ptr(slo), _ptr(lat), _ptr(viol), _ptr(lat_sum),
            _ptr(count), rows, cols, float(_LO), float(_SPAN), *layout)
    ROW_DRAW_MODES[mode] += 1
    shapes = ROW_DRAW_SHAPES[mode]
    shapes[f"{rows}x{cols}"] = shapes.get(f"{rows}x{cols}", 0) + 1
    if mode == "jitter":
        return lat
    return lat, viol, lat_sum, count


def row_draw_bound_ms(mode: str, rows: int, cols: int) -> tuple[float, str]:
    """Least time for one call: the larger of its bytes over the HBM rate
    and its 32-bit integer and float operations over the issue rate."""
    cells = rows * cols
    if mode == "jitter":
        bytes_ = 4 * cells + 12 * rows
        f32_ops = ROW_DRAW_F32_OPS - 3
    else:
        # lat f32 + viol byte out; active byte in (dense) or totals (fused)
        bytes_ = (6 if mode == "dense" else 5) * cells + 28 * rows
        f32_ops = ROW_DRAW_F32_OPS
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = cells * (THREEFRY_INT_OPS + f32_ops) / LANE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ K3 poisson
def poisson_plain(k0, k1, chunk_word, lam) -> torch.Tensor:
    key0, key1 = _row_keys(k0, k1, chunk_word)
    rows, cols = lam.shape
    col = torch.arange(cols, dtype=torch.int64, device=lam.device)[None, :]
    lam64 = lam.to(torch.float64)
    out = torch.zeros((rows, cols), dtype=torch.int64, device=lam.device)
    small = (lam64 > 0) & (lam64 < POISSON_INVERSION_MAX_LAM)
    if bool(small.any()):
        u = _uniform_open01(threefry_bits(key0, key1, 0, col))
        p = torch.exp(-lam64)
        F = p.clone()
        k = torch.zeros_like(out)
        run = small & (u > F)
        while bool(run.any()) and int(k.max()) < _POISSON_MAX_K:
            k = k + run
            p = torch.where(run, p * lam64 / k.to(torch.float64), p)
            F = torch.where(run, F + p, F)
            run = run & (u > F) & (k < _POISSON_MAX_K)
        out = torch.where(small, k, out)
    large = lam64 >= POISSON_INVERSION_MAX_LAM
    if bool(large.any()):
        out = torch.where(large, _ptrs_plain(key0, key1, col, lam64, large),
                          out)
    return out.to(torch.int32)


def _ptrs_plain(key0, key1, col, lam, pending):
    """Hörmann's PTRS over every pending cell, attempt by attempt."""
    safe = torch.where(pending, lam, torch.full_like(lam, 1e5))
    log_lam = torch.log(safe)
    b = 0.931 + 2.53 * torch.sqrt(safe)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    out = torch.floor(safe)
    pending = pending.clone()
    for att in range(1, _POISSON_MAX_ATTEMPTS + 1):
        if not bool(pending.any()):
            break
        u = _uniform_open01(threefry_bits(key0, key1, att, 2 * col)) - 0.5
        v = _uniform_open01(threefry_bits(key0, key1, att, 2 * col + 1))
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a / us + b) * u + safe + 0.43)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -safe + k * log_lam - torch.lgamma(k + 1.0)
        accept = pending & (accept1 | (~reject & (s <= t)))
        out = torch.where(accept, k, out)
        pending = pending & ~accept
    return out.to(torch.int64)


def poisson(k0: torch.Tensor, k1: torch.Tensor, chunk_word: int,
            lam: torch.Tensor) -> torch.Tensor:
    """K3: int32 Poisson(lam) counts, lam (G, S) float32, one draw per
    cell from the row key ``(k0, k1 ^ chunk_word)`` — inversion below
    lam = 100, PTRS rejection at and above it."""
    rows, cols = lam.shape
    _check(lam, torch.float32, (rows, cols), "lam")
    _check(k0, torch.int32, (rows,), "k0")
    _check(k1, torch.int32, (rows,), "k1")
    if not _on_cuda(k0, k1, lam):
        return poisson_plain(k0, k1, chunk_word, lam)
    out = torch.empty((rows, cols), dtype=torch.int32, device=lam.device)
    _launch("poisson", _ptr(k0), _ptr(k1), int(chunk_word) & _M32,
            _ptr(lam), _ptr(out), rows, cols)
    return out


def poisson_bound_terms(lam: np.ndarray, counts: np.ndarray
                        ) -> tuple[float, float, float]:
    """K3's least times for the draws that produced ``counts`` from
    ``lam``, in ms: its bytes over the HBM rate, then its f64-pipe and
    integer-ALU-pipe instructions over their rates. An inversion cell
    (0 < lam < 100) runs ``count`` search steps after its set-up; a PTRS
    cell is counted at one set-up (less than it needs); a cell with
    lam <= 0 costs its write. A step and a set-up cost what the
    kernel's search and set-up blocks take in its SASS
    (:data:`POISSON_STEP_OPS`, :data:`POISSON_SETUP_OPS`)."""
    lam = np.asarray(lam, np.float64)
    counts = np.asarray(counts, np.float64)
    inv = (lam > 0) & (lam < POISSON_INVERSION_MAX_LAM)
    steps = float(counts[inv].sum())
    setups = float(np.count_nonzero(lam > 0))
    # lam in, counts out, and the row's two key words
    t_bytes = (8 * lam.size + 8 * lam.shape[0]) / HBM_BYTES_PER_S
    f64, alu = (steps * st + setups * su for st, su in
                zip(POISSON_STEP_OPS, POISSON_SETUP_OPS))
    return (1e3 * t_bytes, 1e3 * f64 / F64_OPS_PER_S,
            1e3 * alu / ALU_OPS_PER_S)


def poisson_bound_ms(lam: np.ndarray, counts: np.ndarray
                     ) -> tuple[float, str]:
    """Least time for one call: the larger of the bytes and the busier
    pipe's term (:func:`poisson_bound_terms`)."""
    terms = poisson_bound_terms(lam, counts)
    ms = max(terms)
    return ms, ("bytes" if terms[0] >= ms else "operations")
