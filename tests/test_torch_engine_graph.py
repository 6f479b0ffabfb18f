"""The serving engine's decode step as one captured CUDA graph.

On the CPU (counted in every run): the engine never captures and runs
the same fill-and-run step as the card; that step gives the model's own
decode tokens; a stand-in for the graph (``_capture`` patched to rerun
the step into its output) drives the capture's bookkeeping — one
capture at a tenant's second decode step, replays after it, a new
capture when a cache's storage is replaced, the decode span's ``graph``
detail and the ``decode_capture`` instant; DTensor caches and the CPU
are not captured; the port's event vocabulary.

On the card (``-m cuda``): for a dense, a MoE, an encoder-decoder, an
RWKV-6 and a hybrid tenant, one seeded request stream — admissions
mid-run, finished requests, a freed slot reused, a preemption and its
resume — through the eager engine and the graph engine gives the same
tokens and bit-equal caches; each tenant captures once and replays
every later step; the caches never move; and ``fleet.LAUNCHES`` counts
the same kernels run."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import Quota, TenantSpec
from repro_torch.kernels import fleet
from repro_torch.obs import EVENT_KINDS, FlightRecorder
from repro_torch.serving import EngineConfig, MultiTenantEngine, VirtualClock
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.request import Phase

FAMILIES = ("tinyllama-1.1b", "olmoe-1b-7b", "whisper-small", "rwkv6-3b",
            "zamba2-2.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rerun:
    """The CPU's stand-in for a captured graph: capture records the step
    without running it, and each replay reruns it into the output."""

    def __init__(self, fn):
        self.fn = fn
        self.out = torch.empty(0, dtype=torch.int64)

    def replay(self):
        got = self.fn()
        self.out.resize_(got.shape).copy_(got)


def _fake_capture(fn):
    g = _Rerun(fn)
    return g, g.out


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Let the CPU engine take the graph path through :class:`_Rerun`."""
    monkeypatch.setattr(engine_mod, "_capturable",
                        lambda device, cache: True)
    monkeypatch.setattr(engine_mod, "_capture", _fake_capture)


def _drive(arch, device, capture=True, recorder=None, on_step=None):
    """One tenant, slot_cap 3, under a seeded stream on a virtual clock:
    two requests at once (the second finishes after three tokens and
    frees its slot), a third admitted mid-run into that slot, a fourth
    later; at step 8 the quota drops by one slot (the youngest request
    is preempted) and at step 11 it comes back (the request resumes).
    Returns (requests, runtime, the preempted requests, the caches'
    keys seen after each step, kernels launched)."""
    clock = VirtualClock(0.25)
    eng = MultiTenantEngine(
        EngineConfig(policy="none", slot_cap=3, capacity_slots=6,
                     capacity_pages=96, max_seq_len=64,
                     round_interval_steps=10**9, default_units=3),
        seed=11, clock=clock, device=device, recorder=recorder)
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced(arch))
    rt = eng.tenants["t"]
    rt._may_capture = capture
    rng = np.random.default_rng(3)

    def submit(n, new):
        return eng.submit("t", [int(x) for x in rng.integers(1, 200, n)],
                          max_new_tokens=new)
    reqs = [submit(5, 12), submit(9, 3)]
    before = dict(fleet.LAUNCHES)
    keys, preempted = set(), []
    for i in range(200):
        if i == 2:
            reqs.append(submit(7, 10))
        if i == 5:
            reqs.append(submit(6, 9))
        tq = eng.sched.tenants["t"]
        if i == 8:
            eng.ctrl.actuator.apply_quota(
                "t", Quota(len(tq.active) - 1, tq.quota.pages))
            preempted = [r for r in reqs if r.phase == Phase.QUEUED
                         and r.generated]
        if i == 11:
            eng.ctrl.actuator.apply_quota("t", Quota(3, tq.quota.pages))
        clock.tick()
        eng.step()
        keys.add(rt._key())
        if on_step is not None:
            on_step(i, rt)
        if i > 11 and all(r.phase == Phase.DONE for r in reqs):
            break
    launched = {k: n - before[k] for k, n in fleet.LAUNCHES.items()}
    return reqs, rt, preempted, keys, launched


def _check_stream(reqs, preempted):
    assert all(r.phase == Phase.DONE for r in reqs)
    assert [len(r.generated) for r in reqs] == [12, 3, 10, 9]
    assert reqs[2].batch_slot == 1         # the slot the second freed
    assert len(preempted) == 1 and preempted[0] is reqs[3]


# ------------------------------------------------------------------ CPU
def test_cpu_engine_never_captures():
    reqs, rt, preempted, keys, _ = _drive("tinyllama-1.1b", "cpu")
    _check_stream(reqs, preempted)
    assert rt.graph is None and rt.captures == 0 and rt.graph_steps == 0
    assert rt.eager_steps > 10 and rt.capture_s == 0.0
    assert len(keys) == 1


def test_host_views_stage_the_step_inputs():
    eng = MultiTenantEngine(EngineConfig(slot_cap=3, max_seq_len=32),
                            device="cpu")
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced("tinyllama-1.1b"))
    rt = eng.tenants["t"]
    rt.pos[1] = 7
    rt.last_token[2] = 42
    rt.stage()
    assert rt._inputs.tolist() == [[0, 0, 42], [0, 7, 0]]
    assert int(rt.pos[1]) == 7            # the harness reads it as an int


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "olmoe-1b-7b"))
def test_fill_and_run_step_gives_the_models_decode(arch):
    """The step on the static buffers gives the tokens and cache writes
    of ``decode_fn`` on tensors built from the host's arrays (the
    engine's step before the buffers)."""
    eng = MultiTenantEngine(EngineConfig(policy="none", slot_cap=3,
                                         max_seq_len=32), device="cpu")
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced(arch))
    rt = eng.tenants["t"]
    for n in (4, 6):
        eng.submit("t", list(range(3, 3 + n)), max_new_tokens=9)
    for _ in range(3):
        eng.step()
    cache = {k: v.clone() for k, v in rt.cache.items()}
    logits, cache = rt.model.decode_fn(
        rt.params, cache, torch.tensor(rt.last_token), torch.tensor(rt.pos))
    want = torch.argmax(logits, dim=-1)
    rt.stage()
    got, captured = rt.forward()
    assert captured is None
    assert torch.equal(got, want)
    assert all(torch.equal(rt.cache[k], cache[k]) for k in cache)


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "olmoe-1b-7b"))
def test_graph_path_captures_once_and_replays(rerun_graphs, arch):
    rec = FlightRecorder()
    reqs, rt, preempted, keys, _ = _drive(arch, "cpu", recorder=rec)
    _check_stream(reqs, preempted)
    assert rt.captures == 1 and rt.eager_steps == 1
    assert rt.graph_steps > 10 and rt.capture_s > 0
    assert len(keys) == 1
    decodes = [e.detail for e in rec.events_list() if e.kind == "decode"]
    assert [d["graph"] for d in decodes] == \
        [0] + [1] * (len(decodes) - 1)
    caps = [e for e in rec.events_list() if e.kind == "decode_capture"]
    assert len(caps) == 1 and caps[0].tenant == "t"
    assert caps[0].detail["wall"] == rt.capture_s
    assert caps[0].detail["captures"] == 1
    # the same tokens as the eager path
    want = _drive(arch, "cpu", capture=False)[0]
    assert [r.generated for r in reqs] == [r.generated for r in want]


def test_replaced_cache_storage_is_captured_anew(rerun_graphs):
    def move_cache(i, rt):
        if i == 4:
            rt.cache["k"] = rt.cache["k"].clone()
    reqs, rt, preempted, keys, _ = _drive("tinyllama-1.1b", "cpu",
                                          on_step=move_cache)
    _check_stream(reqs, preempted)
    assert rt.captures == 2 and rt.eager_steps == 1
    assert len(keys) == 2
    want = _drive("tinyllama-1.1b", "cpu", capture=False)[0]
    assert [r.generated for r in reqs] == [r.generated for r in want]


def test_capturable_only_on_a_card_over_plain_caches():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import fake_process_group

    cuda = torch.device("cuda")
    plain = {"k": torch.zeros(2, 4), "v": torch.zeros(2, 4)}
    assert engine_mod._capturable(cuda, plain)
    assert not engine_mod._capturable(torch.device("cpu"), plain)
    with fake_process_group(1):
        mesh = init_device_mesh("cpu", (1,))
        mixed = {"k": distribute_tensor(torch.zeros(2, 4), mesh,
                                        [Replicate()]),
                 "v": torch.zeros(2, 4)}
        assert not engine_mod._capturable(cuda, mixed)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_may_capture(arch):
    """No family is kept eager: each one's caches, as the engine lays
    them out, decide for the graph on a card."""
    from repro_torch.models.kvcache import cache_specs
    cache = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for k, s in cache_specs(get_reduced(arch), 3, 32).items()}
    assert engine_mod._capturable(torch.device("cuda"), cache)


def test_event_vocabulary_is_the_references_and_the_engines():
    from repro.obs import EVENT_KINDS as REF_EVENT_KINDS
    assert REF_EVENT_KINDS <= EVENT_KINDS
    assert EVENT_KINDS - REF_EVENT_KINDS == {
        "engine_step", "prefill", "decode", "decode_capture"}


# ------------------------------------------------------------------ CUDA
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU form)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_graph_decode_equals_eager(cuda_device, arch):
    got = _drive(arch, cuda_device)
    want = _drive(arch, cuda_device, capture=False)
    (reqs, rt, preempted, keys, launched) = got
    (ereqs, ert, epreempted, ekeys, elaunched) = want
    _check_stream(reqs, preempted)
    _check_stream(ereqs, epreempted)
    assert [r.generated for r in reqs] == [r.generated for r in ereqs]
    assert set(rt.cache) == set(ert.cache)
    for k in rt.cache:
        assert torch.equal(rt.cache[k], ert.cache[k]), k
    assert rt.captures == 1 and rt.eager_steps == 1
    assert rt.graph_steps == ert.eager_steps - 1
    assert ert.captures == 0 and ert.graph is None
    assert len(keys) == 1
    assert launched == elaunched
