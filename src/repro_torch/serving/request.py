"""Request/session types for the multi-tenant engine."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    EVICTED = "evicted"          # redirected to the Cloud tier


@dataclass
class Request:
    rid: int
    tenant: str
    prompt: list[int]
    max_new_tokens: int
    arrival_t: float
    user: int = 0


@dataclass
class RequestState:
    req: Request
    phase: Phase = Phase.QUEUED
    generated: list[int] = field(default_factory=list)
    batch_slot: int = -1         # slot in the tenant's decode batch
    first_token_t: float | None = None
    finish_t: float | None = None
    # resilience (serving federation timeouts): a request not finished
    # by timeout_t is pulled back, retried after a backoff (not_before
    # gates re-admission), and Cloud-serviced once retries are spent
    retries: int = 0
    not_before: float = 0.0
    timeout_t: float | None = None

    @property
    def context_len(self) -> int:
        return len(self.req.prompt) + len(self.generated)

    def latency(self) -> float | None:
        if self.finish_t is None:
            return None
        return self.finish_t - self.req.arrival_t

    def ttft(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.req.arrival_t
