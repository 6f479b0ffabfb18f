"""Multi-tenant serving engine with DYVERSE dynamic vertical scaling.

Each tenant serves its own model (any of the 10 assigned archs). The
engine runs continuous batching per tenant inside a shared loop; DYVERSE
periodically reallocates (slots, pages) quotas based on measured request
latencies vs each tenant's SLO. Quota actuation is control-plane-only:
the scheduler admits/preempts; no weights or caches move.

Preemption contract: a DECODE-phase victim of a quota shrink keeps its
``generated`` tokens and its ``first_token_t``. On re-admission the
engine re-prefills the FULL decoded context minus the last generated
token and feeds that token back at the restored KV position, so the
continuation is bitwise-identical to a run that was never preempted
(greedy decode on the same weights), TTFT is not reset, and nothing is
double-appended. The actuator also clears the runtime's batch slot for
every preempted request — a victim must stop decoding the moment it
leaves the active set, or it would keep generating into a slot that
``free_slot`` can hand to someone else.

Time: every timestamp the engine takes (arrival, first token, finish)
comes from the injectable ``clock`` callable — ``time.perf_counter`` by
default, or a :class:`~repro_torch.serving.spec.VirtualClock` for
deterministic simulation-grade runs (the serving federation's
determinism contract).

Device: every tenant's weights and its caches (the dense and MoE
families' (L, slot_cap, Smax, KH, hd) KV cache, the encoder-decoder's
beside its cross KV, RWKV-6's per-layer states, the hybrid family's
shared-attention KV and Mamba-2 states) live on the engine's
``device`` — ``"cuda"`` unless the caller asks for ``"cpu"``.
On the card, attention prefill runs through the flash kernel K4 and
decode through the paged kernel K5
(:mod:`repro_torch.kernels.attention`), the RWKV-6 recurrence through
K6 and the SSD scan through K7; the caches are updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (DyverseController, NodeCapacity, Quota,
                              ResourceUnit, TenantSpec)
from repro_torch.kernels.fleet import check_device
from repro_torch.models import build_model
from repro_torch.models.kvcache import cache_specs
from repro_torch.serving.request import Phase, Request, RequestState
from repro_torch.serving.scheduler import QuotaScheduler

CLOUD_LATENCY_S = 0.25       # WAN penalty for evicted/offloaded requests


@dataclass
class EngineConfig:
    page_size: int = 16
    slot_cap: int = 8                 # compiled decode batch per tenant
    max_seq_len: int = 128
    round_interval_steps: int = 40    # engine steps between DYVERSE rounds
    policy: str = "sdps"
    capacity_slots: int = 16
    capacity_pages: int = 256
    default_units: int = 2            # × uR(1 slot, 8 pages)


class _EngineActuator:
    def __init__(self, engine: "MultiTenantEngine"):
        self.engine = engine

    def apply_quota(self, tenant: str, quota: Quota) -> None:
        eng = self.engine
        sched = eng.sched
        # defensive clamp only: spec.max_units (set at add_tenant) keeps
        # the controller from ever granting slots past slot_cap, so the
        # enforced quota and the billed quota are the same object
        q = Quota(min(quota.slots, eng.cfg.slot_cap), quota.pages)
        if tenant in sched.tenants:
            preempted = sched.set_quota(tenant, q)
            rt = eng.tenants.get(tenant)
            if rt is not None and preempted:
                # a preemption victim must leave its decode slot NOW —
                # otherwise _decode_step keeps generating for a request
                # that is back in the waiting queue
                victims = {id(r) for r in preempted}
                for i, r in enumerate(rt.slot_req):
                    if r is not None and id(r) in victims:
                        rt.slot_req[i] = None
        else:
            sched.add_tenant(tenant, q)

    def terminate(self, tenant: str) -> None:
        self.engine._evict_tenant(tenant)


class TenantRuntime:
    """Per-tenant model + cache + step functions, on ``device``."""

    def __init__(self, name: str, cfg: ModelConfig, eng: EngineConfig,
                 generator: torch.Generator, device: torch.device):
        self.name = name
        self.cfg = cfg
        self.device = device
        self.model = build_model(cfg, device=device, generator=generator)
        self.params = self.model.params
        B, S = eng.slot_cap, eng.max_seq_len
        specs = self.model.cache_specs(B, S)
        self.cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                      for k, s in specs.items()}
        self.pos = np.zeros(B, np.int64)           # next write index per slot
        self.slot_req: list[RequestState | None] = [None] * B
        self._decode = self.model.decode_fn
        self._prefill = self.model.prefill_fn
        self.last_token = np.zeros(B, np.int64)

    def free_slot(self) -> int:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return -1


class MultiTenantEngine:
    def __init__(self, cfg: EngineConfig | None = None, seed: int = 0,
                 clock: Callable[[], float] | None = None, device="cuda"):
        self.cfg = cfg or EngineConfig()
        self.device = check_device(device)
        self.clock = clock or time.perf_counter
        self.sched = QuotaScheduler(self.cfg.page_size)
        self.ctrl = DyverseController(
            capacity=NodeCapacity(slots=self.cfg.capacity_slots,
                                  pages=self.cfg.capacity_pages),
            uR=ResourceUnit(slots=1, pages=self.cfg.capacity_pages
                            // max(self.cfg.capacity_slots, 1)),
            policy=self.cfg.policy,
            default_units=self.cfg.default_units,
            actuator=_EngineActuator(self),
        )
        self.tenants: dict[str, TenantRuntime] = {}
        # one weight seed per admitted tenant, spawned in admission order
        self._seeds = np.random.SeedSequence(seed)
        self._rid = 0
        self.steps = 0
        self.completed: list[RequestState] = []
        self.cloud_serviced: list[RequestState] = []
        # federation seam: when set, Procedure-3 terminations hand their
        # live queue to this hook instead of the Cloud path; returning
        # True claims the requests (the federation migrates them)
        self.evict_hook: Callable[[str, list[RequestState]], bool] | None \
            = None

    # ------------------------------------------------------------ lifecycle
    def add_tenant(self, spec: TenantSpec, model_cfg: ModelConfig) -> bool:
        # cap the controller at what the scheduler can enforce: quota
        # slots beyond the compiled decode batch (slot_cap) would be
        # clamped at actuation, so units past that cap must never be
        # billed against NodeCapacity (Eq. 1 must see enforced quotas)
        cap_units = self.cfg.slot_cap // max(self.ctrl.pool.uR.slots, 1)
        if spec.max_units is None or spec.max_units > cap_units:
            spec = dataclasses.replace(spec, max_units=cap_units)
        res = self.ctrl.admit(spec)
        if not res.admitted:
            return False
        gen = torch.Generator(device=self.device).manual_seed(
            int(self._seeds.spawn(1)[0].generate_state(1)[0]))
        self.tenants[spec.name] = TenantRuntime(spec.name, model_cfg,
                                                self.cfg, gen, self.device)
        return True

    def _evict_tenant(self, tenant: str) -> None:
        """Procedure 3 actuation: flush runtime, redirect requests to the
        Cloud — unless a federation's ``evict_hook`` claims the queue for
        migration to a sibling node."""
        rts = self.sched.remove_tenant(tenant)
        self.tenants.pop(tenant, None)
        if self.evict_hook is not None and self.evict_hook(tenant, rts):
            return
        now = self.clock()
        for rs in rts:
            rs.finish_t = now + CLOUD_LATENCY_S
            self.cloud_serviced.append(rs)

    def submit(self, tenant: str, prompt: list[int],
               max_new_tokens: int = 8, user: int = 0) -> RequestState:
        self._rid += 1
        req = Request(rid=self._rid, tenant=tenant, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival_t=self.clock(), user=user)
        if tenant not in self.tenants:
            rs = RequestState(req=req, phase=Phase.EVICTED)
            rs.finish_t = req.arrival_t + CLOUD_LATENCY_S
            self.cloud_serviced.append(rs)
            return rs
        return self.sched.submit(req)

    # ------------------------------------------------------------ stepping
    def step(self) -> None:
        for name in list(self.tenants):
            rt = self.tenants[name]
            # admit new requests within quota and prefill them (requests
            # inside a retry backoff window stay queued until not_before)
            for rs in self.sched.admit_waiting(name, self.clock()):
                slot = rt.free_slot()
                if slot < 0:
                    # shouldn't happen (slots quota ≤ slot_cap) but be safe
                    self.sched.tenants[name].active.remove(rs)
                    rs.phase = Phase.QUEUED
                    self.sched.tenants[name].waiting.appendleft(rs)
                    continue
                self._prefill_into_slot(rt, rs, slot)
            # one decode step for all active slots
            if any(r is not None for r in rt.slot_req):
                self._decode_step(rt)
        self.steps += 1
        if self.cfg.policy != "none" and \
                self.steps % self.cfg.round_interval_steps == 0:
            self.ctrl.run_round()

    def _prefill_into_slot(self, rt: TenantRuntime, rs: RequestState,
                           slot: int) -> None:
        cfg = rt.cfg
        resumed = bool(rs.generated)
        if resumed:
            # preemption resume: rebuild KV for the full decoded context
            # EXCEPT the last generated token — the next decode step
            # feeds it back at the restored position, so the token
            # stream continues exactly where it stopped (no re-prefill
            # of just the prompt, no duplicate first token)
            ctx = rs.req.prompt + rs.generated[:-1]
        else:
            ctx = rs.req.prompt
        tokens = torch.tensor(ctx, dtype=torch.int64,
                              device=rt.device)[None, :]
        logits, cache1 = rt._prefill(rt.params, prefill_batch(cfg, tokens))
        rt.cache = _insert_cache(rt.cache, cache1, slot, cfg,
                                 self.cfg.max_seq_len)
        if resumed:
            tok = rs.generated[-1]
        else:
            tok = int(torch.argmax(logits[0]))
            rs.generated.append(tok)
        if rs.first_token_t is None:     # TTFT survives preemption
            rs.first_token_t = self.clock()
        rs.phase = Phase.DECODE
        rs.batch_slot = slot
        rt.slot_req[slot] = rs
        rt.pos[slot] = len(ctx)
        rt.last_token[slot] = tok

    def _decode_step(self, rt: TenantRuntime) -> None:
        token = torch.tensor(rt.last_token, device=rt.device)
        pos = torch.tensor(rt.pos, device=rt.device)
        logits, rt.cache = rt._decode(rt.params, rt.cache, token, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        t_done = self.clock()
        for slot, rs in enumerate(rt.slot_req):
            if rs is None:
                continue
            rs.generated.append(int(nxt[slot]))
            rt.pos[slot] += 1
            rt.last_token[slot] = int(nxt[slot])
            done = (len(rs.generated) >= rs.req.max_new_tokens
                    or rt.pos[slot] >= self.cfg.max_seq_len - 1)
            if done:
                self.sched.finish(rt.name, rs, t_done)
                st = self.ctrl.registry.get(rt.name)
                if st is not None:
                    self.ctrl.monitor.record_request(
                        rt.name, rs.latency(), st.spec.slo_latency,
                        data_mb=len(rs.generated) * 4e-6, user=rs.req.user)
                rt.slot_req[slot] = None
                self.completed.append(rs)

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()

    def drain(self, max_steps: int = 2000) -> None:
        for _ in range(max_steps):
            if not any(tq.active or tq.waiting
                       for tq in self.sched.tenants.values()):
                return
            self.step()


def prefill_batch(cfg: ModelConfig, tokens) -> dict:
    """The prefill batch of a request's tokens (1, S): for an
    encoder-decoder also ``frames``, zeros (1, max(S // ratio, 1), D) in
    bf16 on the tokens' device — the conv frontend is a stub, and the
    reference's engine feeds it zeros."""
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        Se = max(tokens.shape[1] // cfg.encoder_seq_ratio, 1)
        batch["frames"] = torch.zeros((1, Se, cfg.d_model),
                                      dtype=torch.bfloat16,
                                      device=tokens.device)
    return batch


def _insert_cache(cache, cache1, slot: int, cfg: ModelConfig, max_len: int):
    """Insert a single-request prefill cache into the batch caches at
    ``slot``, in place, cast to each cache's dtype, along the batch axis
    of its spec (:func:`~repro_torch.models.kvcache.cache_specs`): a
    cache with a sequence axis takes the prefill's S positions and
    zeros past them (the reference's zero padding; the cross K/V's
    padding too, which the encoder-decoder's decode attends over); a
    fixed-size state is whole."""
    for k, spec in cache_specs(cfg, 1, max_len).items():
        dst = cache[k].select(spec.batch_axis, slot)
        src = cache1[k].select(spec.batch_axis, 0)
        if spec.seq_axis is None:
            dst.copy_(src)
        else:
            ax = spec.seq_axis - (spec.seq_axis > spec.batch_axis)
            S = src.shape[ax]
            dst.narrow(ax, 0, S).copy_(src)
            dst.narrow(ax, S, dst.shape[ax] - S).zero_()
    return cache
