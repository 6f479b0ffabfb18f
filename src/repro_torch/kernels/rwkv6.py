"""K6: the RWKV-6 recurrence, beside its plain torch version.

========== ================================= ============================
kernel     replaces (JAX package)            bound on an H100
========== ================================= ============================
K6 rwkv6   ``rwkv6._kernel`` /               bytes (r, k, v, w read and o
           ``rwkv6_forward`` (Pallas,        written once); the quicker
           kernels/rwkv6.py)                 of the recurrence and the
                                             chunked form comes below
========== ================================= ============================

The kernel runs in parallel over chunks of ``CHUNK`` steps: each
chunk's state update from zero as one product (on the tensor cores for
bf16 inputs, as f32 FMAs for f32), a sequential pass of the (K, K) state
over the chunks, then the recurrence over every chunk at once from its
start state — three launches in one call with an f32 scratch the
wrapper allocates.

Per head, with the (K, K) f32 state S and data-dependent decay w_t:
``o_t = r_t·(S + diag(u)·k_t v_tᵀ)``, ``S ← diag(w_t)·S + k_t v_tᵀ``.
The CUDA source is ``repro_torch/csrc/rwkv6.cu`` (built and bound by
:mod:`repro_torch.kernels.fleet`). The wrapper takes its plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises (no fallback); each launch adds one to ``fleet.LAUNCHES``. The
plain version is the JAX package's per-step oracle ``rwkv6_ref``: the
CPU path of the model and the oracle on the card.

Layout follows B4: r/k/v/w (B, H, T, K), u (H, K), states (B, H, K, K)
f32. The kernel reads through element strides (the last dimension
contiguous), so the model's (B, T, H, K) projections pass as transposed
views; on CUDA the output is a (B, H, T, K) view of a (B, T, H, K)
tensor. B4's ``chunk`` only frames its copies to VMEM and does not
change the function, so neither version takes one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import fleet
from repro_torch.kernels.attention import (_DTYPE_CODE, BF16_FLOPS_PER_S,
                                           F32_FLOPS_PER_S,
                                           _check_vector_rows, _on_cuda,
                                           _strides)

HEAD_SIZES = (16, 32, 64)
#: the kernel's chunk: its phases run in parallel over chunks of this many
#: steps, and only the state hand-off between them is sequential
CHUNK = 64


def rwkv6_forward_plain(r, k, v, w, u, init_state=None):
    """The per-step loop of the JAX package's ``rwkv6_ref``, in f32 (in
    f64 for f64 inputs: the oracle the kernel is held to on the card).
    Returns (o in r's dtype, final state in that precision)."""
    B, H, T, K = r.shape
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    s = (torch.zeros((B, H, K, K), dtype=acc, device=r.device)
         if init_state is None else init_state.to(acc))
    uf = u.to(acc)[None, :, :, None]
    outs = []
    for t in range(T):
        rt, kt, vt, wt = (x[:, :, t].to(acc) for x in (r, k, v, w))
        kv = kt[..., None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + uf * kv))
        s = wt[..., None] * s + kv
    o = torch.stack(outs, dim=2) if outs else r.to(acc)
    return o.to(r.dtype), s


def rwkv6_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  init_state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: r/k/v (B, H, T, K) f32 or bf16 of one dtype; w (B, H, T, K)
    decay in (0, 1), f32; u (H, K); init_state (B, H, K, K) or None
    (zeros). Returns (o (B, H, T, K) in r's dtype, final state
    (B, H, K, K) f32)."""
    B, H, T, K = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (H, K) or (init_state is not None and
                                            tuple(init_state.shape)
                                            != (B, H, K, K))):
        raise ValueError(
            f"rwkv6_forward: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"init_state "
            f"{None if init_state is None else tuple(init_state.shape)}")
    extra = () if init_state is None else (init_state,)
    if not _on_cuda(r, k, v, w, u, *extra):
        return rwkv6_forward_plain(r, k, v, w, u, init_state)
    if K not in HEAD_SIZES:
        raise ValueError(f"rwkv6 head size {K} not in {HEAD_SIZES}: the "
                         f"kernel is compiled for those only")
    if (r.dtype not in _DTYPE_CODE or k.dtype != r.dtype
            or v.dtype != r.dtype or w.dtype != torch.float32):
        raise ValueError(f"rwkv6_forward takes f32 or bf16 r/k/v of one "
                         f"dtype and f32 w, got {r.dtype}/{k.dtype}/"
                         f"{v.dtype}/{w.dtype}")
    _check_vector_rows(r, k, v, w, what="rwkv6")
    u = u.float().contiguous()
    s0 = None if init_state is None else init_state.float().contiguous()
    o = torch.empty((B, T, H, K), dtype=r.dtype,
                    device=r.device).transpose(1, 2)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    # the chunks' state updates (then their start states) and decays,
    # for the kernel's three phases
    nc = -(-T // CHUNK)
    scratch = torch.empty(B * H * nc * (K * K + K), dtype=torch.float32,
                          device=r.device)
    strides = _strides(r, k, v, w, o)    # alive until the launch returns
    fleet._launch("rwkv6", _DTYPE_CODE[r.dtype], K, r.data_ptr(),
                  k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  None if s0 is None else s0.data_ptr(), o.data_ptr(),
                  s_out.data_ptr(), B, H, T, scratch.data_ptr(),
                  ctypes.addressof(strides))
    return o, s_out


def rwkv6_bound_ms(B: int, H: int, T: int, K: int, *, itemsize: int = 2,
                   init_state: bool = False) -> tuple[float, str]:
    """Least time for one call: r, k, v and w read and o written once
    (w in f32), u read, the final state written (and the initial one
    read); the operations of the quicker of the function's two forms:
    the recurrence, 5·K² f32 FLOPs per (step, head) — r·S, the bonus
    term, and the decay update w·S + k·v — at the f32 rate (the state is
    f32), or the chunked form, 4·L·K + 4·K² per (step, head) at chunk
    L = min(CHUNK, T), on bf16 tensor cores for bf16 inputs (for f32
    inputs at the f32 rate)."""
    bytes_ = (B * H * T * K * (4 * itemsize + 4) + 4 * H * K
              + 4 * B * H * K * K * (2 if init_state else 1))
    L = min(CHUNK, T)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_ops = min(5 * K * K * B * H * T / F32_FLOPS_PER_S,
                (4 * L * K + 4 * K * K) * B * H * T / rate)
    t_bytes = bytes_ / fleet.HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
