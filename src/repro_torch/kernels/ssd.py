"""K7: the Mamba-2 SSD chunk scan, beside its plain torch version.

========== ================================= ============================
kernel     replaces (JAX package)            bound on an H100
========== ================================= ============================
K7 ssd     ``ssd._kernel`` / ``ssd_forward`` bf16: bytes (x read and
           (Pallas, kernels/ssd.py)          y written once; the chunked
                                             form on tensor cores comes
                                             below that); f32: the
                                             recurrence's 5·P·N FLOPs a
                                             step at the f32 rate
========== ================================= ============================

The kernel runs in parallel over chunks of 64 steps: chunk summaries,
a sequential pass of the (P, N) state over the chunks, then each chunk's
output, three launches in one call with an f32 scratch the wrapper
allocates. On bf16 inputs its products run on the tensor cores with
TF32 operands; on f32 inputs as f32 FMAs.

Per head h (P channels, N state), with a = -exp(a_log[h]):
``S_t = exp(dt_t·a)·S_{t-1} + dt_t·x_t ⊗ B_t``, ``y_t = S_t·C_t``, in
the state-space dual (chunked) form. The CUDA source is
``repro_torch/csrc/ssd.cu`` (built and bound by
:mod:`repro_torch.kernels.fleet`). The wrapper takes its plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises (no fallback); each launch adds one to ``fleet.LAUNCHES``. The
plain version is the JAX package's ``ssd_chunked`` written in B5's
layout: the CPU path of the model and the oracle on the card.

Layout follows B5: x (B, H, T, P), dt (B, H, T) f32 after softplus,
a_log (H,), B/C (B, T, N) shared across heads, states (B, H, P, N) f32.
The kernel reads through element strides (the last dimension
contiguous), so the model's (B, T, H, P) activations and the B/C
columns of its conv output pass as views; on CUDA the output is a
(B, H, T, P) view of a (B, T, H, P) tensor. Both versions keep the
reference's contract that T is a multiple of ``min(chunk, T)``; the
kernel cuts chunks of its own (``KERNEL_CHUNK`` steps), which does not
change the function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import fleet
from repro_torch.kernels.attention import (BF16_FLOPS_PER_S,
                                           F32_FLOPS_PER_S, _on_cuda,
                                           _strides)

CHUNK = 128
#: the kernel's own chunk: its phases run in parallel over chunks of this
#: many steps, and only the state hand-off between them is sequential
KERNEL_CHUNK = 64
#: largest state/channel widths whose chunk fits the 227 KiB of shared
#: memory a block can opt into
MAX_WIDTH = 128
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.bfloat16, torch.bfloat16): 1,
           (torch.bfloat16, torch.float32): 2}


def _check_chunk(T: int, chunk: int) -> int:
    c = min(chunk, T)
    if c and T % c:
        raise ValueError(f"seq {T} not a multiple of chunk {c}")
    return c


def ssd_forward_plain(x, dt, a_log, Bm, Cm, *, chunk: int = CHUNK,
                      init_state=None):
    """The chunked SSD of the JAX package's ``ssd_chunked`` in f32 (in
    f64 for f64 inputs: the oracle the kernel is held to on the card):
    intra-chunk products with the causal decay matrix, chunk summaries,
    and the inter-chunk state pass. Returns (y in x's dtype, final
    state)."""
    B, H, T, P = x.shape
    N = Bm.shape[-1]
    L = _check_chunk(T, chunk)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    s = (torch.zeros((B, H, P, N), dtype=acc, device=x.device)
         if init_state is None else init_state.to(acc))
    if T == 0:
        return x.clone(), s
    nc = T // L
    a = -torch.exp(a_log.to(acc))                               # (H,)
    da = dt.to(acc) * a[None, :, None]                          # (B,H,T)
    xc = (x.to(acc) * dt.to(acc)[..., None]).reshape(B, H, nc, L, P)
    Bc = Bm.to(acc).reshape(B, nc, L, N)
    Cc = Cm.to(acc).reshape(B, nc, L, N)
    cum = torch.cumsum(da.reshape(B, H, nc, L), dim=-1)        # (B,H,nc,L)

    # intra-chunk: y[i] = Σ_{j≤i} exp(cum_i - cum_j)·(C_i·B_j)·x̃_j
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # (B,nc,L,L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    dmat = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                       float("-inf"))
    M = CB[:, None] * torch.exp(dmat)                           # (B,H,nc,L,L)
    y = torch.einsum("bhcij,bhcjp->bhcip", M, xc)

    # chunk summaries: S_c = Σ_j exp(cum_L - cum_j)·x̃_j ⊗ B_j
    dec_end = torch.exp(cum[..., -1:] - cum)                    # (B,H,nc,L)
    S_c = torch.einsum("bcln,bhclp,bhcl->bhcpn", Bc, xc, dec_end)
    chunk_dec = torch.exp(cum[..., -1])                         # (B,H,nc)

    # inter-chunk pass: each chunk reads the state before it
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_dec[:, :, c, None, None] + S_c[:, :, c]
    y = y + torch.einsum("bcln,bhcl,bhcpn->bhclp", Cc, torch.exp(cum),
                         torch.stack(s_prevs, dim=2))
    return y.reshape(B, H, T, P).to(x.dtype), s


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = CHUNK,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: x (B, H, T, P) f32 or bf16; dt (B, H, T) f32; a_log (H,);
    Bm/Cm (B, T, N) of one dtype (x's, or f32 with bf16 x);
    init_state (B, H, P, N) or None (zeros). T must be a multiple of
    ``min(chunk, T)``, as in the reference. Returns (y (B, H, T, P) in
    x's dtype, final state (B, H, P, N) f32)."""
    B, H, T, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, H, T) or tuple(a_log.shape) != (H,)
            or tuple(Bm.shape) != (B, T, N) or Cm.shape != Bm.shape
            or (init_state is not None
                and tuple(init_state.shape) != (B, H, P, N))):
        raise ValueError(
            f"ssd_forward: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
            f"{tuple(a_log.shape)}, B {tuple(Bm.shape)}, C "
            f"{tuple(Cm.shape)}, init_state "
            f"{None if init_state is None else tuple(init_state.shape)}")
    _check_chunk(T, chunk)
    extra = () if init_state is None else (init_state,)
    if not _on_cuda(x, dt, a_log, Bm, Cm, *extra):
        return ssd_forward_plain(x, dt, a_log, Bm, Cm, chunk=chunk,
                                 init_state=init_state)
    code = _DTYPES.get((x.dtype, Bm.dtype))
    if code is None or Cm.dtype != Bm.dtype or dt.dtype != torch.float32:
        raise ValueError(f"ssd_forward: unsupported dtypes x {x.dtype}, "
                         f"B/C {Bm.dtype}/{Cm.dtype}, dt {dt.dtype}")
    if P % 4 or N % 4 or P > MAX_WIDTH or N > MAX_WIDTH:
        raise ValueError(f"ssd_forward: the kernel takes P and N that are "
                         f"multiples of 4 up to {MAX_WIDTH}, got {P}, {N}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd_forward: the last dimension of x, B and C "
                         "must be contiguous")
    a_log = a_log.float().contiguous()
    s0 = None if init_state is None else init_state.float().contiguous()
    y = torch.empty((B, T, H, P), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    s_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # the chunk summaries, then each chunk's start state, and the chunks'
    # decays, for the kernel's three phases
    nc = -(-T // KERNEL_CHUNK)
    scratch = torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                          device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *_strides(x, dt), *[int(s) for t in (Bm, Cm) for s in t.stride()[:2]],
        *_strides(y))                    # alive until the launch returns
    fleet._launch("ssd", code, x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(),
                  None if s0 is None else s0.data_ptr(), y.data_ptr(),
                  s_out.data_ptr(), B, H, T, P, N, scratch.data_ptr(),
                  ctypes.addressof(strides))
    return y, s_out


def ssd_bound_ms(B: int, H: int, T: int, P: int, N: int, *,
                 itemsize: int = 2, bc_itemsize: int = 2,
                 init_state: bool = False) -> tuple[float, str]:
    """Least time for one call: x read and y written once, B, C and dt
    read once, the final state written (and the initial one read); the
    operations of the quicker of the function's two forms: the
    recurrence, 5·P·N f32 FLOPs per (step, head) — decay, x̃ ⊗ B and
    S·C — at the f32 rate (the state is f32), or the chunked form,
    2·L·(N + P) + 4·N·P per (step, head) at the reference's chunk L =
    min(128, T), on bf16 tensor cores for bf16 inputs (for f32 inputs
    at the f32 rate, where the recurrence is always the fewer)."""
    L = min(CHUNK, T)
    bytes_ = (2 * B * H * T * P * itemsize + 2 * B * T * N * bc_itemsize
              + 4 * B * H * T + 4 * H
              + 4 * B * H * P * N * (2 if init_state else 1))
    chunked = 2 * B * H * T * (L * N + L * P + 2 * N * P)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_ops = min(5 * B * H * T * P * N / F32_FLOPS_PER_S, chunked / rate)
    t_bytes = bytes_ / fleet.HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
