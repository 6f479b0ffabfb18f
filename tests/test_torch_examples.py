"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``), run in this process on the CPU: the
reference's through its ``main`` with ``sys.argv`` patched and its
printout captured, the port's through ``main(argv)`` or ``run(...)``.

- ``federation_demo`` on the numpy engines, ``--quick``: the printed
  table equal line for line but for the wall-clock figures that
  ``ScenarioResult.table()`` prints, masked: each policy row's
  ``max-ovh`` (ms) and ``wall`` (s) columns and the "max per-node round
  overhead" line's ms; ``--list-scenarios`` and ``--list-campaigns``
  equal.
- ``multitenant_serve``: the printout equal line for line (admissions,
  quotas, VR, evictions, p50/p95, scale events), both engines on a
  virtual clock that advances 0.25 s an engine step (the example's own
  engine reads the wall clock); outcomes depend only on it and on token
  counts, so the weights may differ.
- ``quickstart`` (a dense, an MoE and a recurrent arch), ``train_100m
  --tiny`` and ``elastic_restart`` on the reference's weights carried
  with ``params_from_jax(..., trainable=True)``: every printed loss
  within 1e-2 (the configs are bf16; PERF.md §2's training limit), the
  greedy continuation equal to the reference's up to a near-tie: the
  port's model, fed the reference's tokens, must pick each of them,
  except that at the first token where it picks another the two
  logits may be within 5e-2 (``test_torch_families.py``'s bf16 logit
  tolerance; the weights after three bf16 steps differ in rounding,
  and the reduced models' largest logits are 0.4-0.6), after which the
  streams part; ``elastic_restart``'s resumed loss equal bit for bit
  to the uninterrupted one.
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BF16_LOSS_TOL = 1e-2
BF16_LOGIT_TOL = 5e-2


def ref_example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_ref(name, argv, monkeypatch, capsys, patch=None) -> str:
    mod = ref_example(name)
    if patch:
        patch(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    mod.main()
    return capsys.readouterr().out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def losses(out: str) -> list[float]:
    return [float(x) for x in re.findall(r"loss[=@\d ]*= ?(-?\d+\.\d+)",
                                         out)]


# ---------------------------------------------------------------- federation
def mask_walls(out: str) -> list[str]:
    """The printout's lines with the wall-clock figures masked: ms values
    (``max-ovh``, the round-overhead line) and a row's closing wall."""
    lines = []
    for line in out.splitlines():
        line = re.sub(r"\d+\.\d+ms", "<ms>", line)
        lines.append(re.sub(r" +\d+\.\d+s$", " <wall>", line))
    return lines


@pytest.mark.parametrize("argv", [
    ["--quick"],
    ["--quick", "--engine", "vectorized"],
    ["--quick", "--scenario", "paper_face_detection"],
    ["--quick", "--scenario", "proactive_game_32", "--policy", "proactive",
     "--forecaster", "linear_trend"],
])
def test_federation_demo_table_equals_reference(argv, monkeypatch, capsys):
    from repro_torch.examples import federation_demo

    want = run_ref("federation_demo", argv, monkeypatch, capsys)
    federation_demo.main(argv)
    got = capsys.readouterr().out
    assert mask_walls(got) == mask_walls(want)
    assert "<wall>" in "\n".join(mask_walls(got))


@pytest.mark.parametrize("flag", ["--list-scenarios", "--list-campaigns"])
def test_federation_demo_lists_equal_reference(flag, monkeypatch, capsys):
    from repro_torch.examples import federation_demo

    want = run_ref("federation_demo", [flag], monkeypatch, capsys)
    federation_demo.main([flag])
    # the port's ci campaign runs the torch engine where the reference's
    # runs jax (repro_torch.campaign.registry)
    assert capsys.readouterr().out == want.replace("/jax/", "/torch/")


# ---------------------------------------------------------------- serving
def ticking(engine_cls, clock_cls):
    """``engine_cls`` on a virtual clock that advances 0.25 s before each
    engine step."""
    class Ticking(engine_cls):
        def __init__(self, cfg, **kw):
            self.vclock = clock_cls(0.25)
            super().__init__(cfg, clock=self.vclock, **kw)

        def step(self):
            self.vclock.tick()
            super().step()
    return Ticking


def test_multitenant_serve_printout_equals_reference(monkeypatch, capsys):
    import repro.serving as RS
    import repro_torch.serving as PS
    from repro_torch.examples import multitenant_serve

    def patch(mod):
        mod.MultiTenantEngine = ticking(RS.MultiTenantEngine,
                                        RS.VirtualClock)
    want = run_ref("multitenant_serve", [], monkeypatch, capsys, patch)
    monkeypatch.setattr(multitenant_serve, "MultiTenantEngine",
                        ticking(PS.MultiTenantEngine, PS.VirtualClock))
    multitenant_serve.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "scale events:" in got and "p95=" in got


# ---------------------------------------------------------------- training
def ref_weights(cfg):
    """The reference's ``init_params(key(0))`` of ``cfg`` as numpy."""
    from repro.models import build_model as ref_build
    return jax.tree.map(np.asarray,
                        ref_build(cfg).init_params(jax.random.key(0)))


def carried(port_cfg, ref_cfg):
    from repro_torch.models import params_from_jax
    return params_from_jax(port_cfg, ref_weights(ref_cfg), device="cpu",
                           trainable=True)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "rwkv6-3b"])
def test_quickstart_matches_reference(arch, monkeypatch, capsys):
    from repro.configs import get_reduced as ref_reduced
    from repro_torch.configs import get_reduced
    from repro_torch.examples import quickstart

    argv = ["--arch", arch, "--steps", "3"]
    want = run_ref("quickstart", argv, monkeypatch, capsys)
    got = quickstart.run(arch, 3, "cpu", params=carried(
        get_reduced(arch), ref_reduced(arch)))
    out = capsys.readouterr().out
    assert out.splitlines()[0] == want.splitlines()[0]
    ref_losses = losses(want)
    assert len(ref_losses) == 3
    np.testing.assert_allclose(got["loss"], ref_losses, rtol=0,
                               atol=BF16_LOSS_TOL)
    ref_cont = [int(x) for x in re.search(
        r"greedy continuation: \[(.*)\]", want).group(1).split(",")]
    assert len(got["continuation"]) == len(ref_cont) == 6
    if got["continuation"] != ref_cont:
        near_tie_at_first_difference(got["model"], got["state"], ref_cont)


def near_tie_at_first_difference(model, state, ref_cont):
    """Feed the reference's continuation through the port's prefill and
    decode: up to the first token the port picks otherwise it picks the
    reference's, and there the reference's token's logit is within
    BF16_LOGIT_TOL of the largest."""
    from repro_torch.models.kvcache import grow_cache

    logits, cache = model.prefill_fn(
        state.params, {"tokens": torch.arange(1, 9)[None]})
    cache = grow_cache(model.cfg, cache, 16)
    for t, tok in enumerate(ref_cont):
        lg = logits[0].float()
        top = int(lg.argmax())
        if top != tok:
            gap = float(lg[top] - lg[tok])
            assert gap <= BF16_LOGIT_TOL, (t, tok, top, gap)
            return
        logits, cache = model.decode_fn(state.params, cache,
                                        torch.tensor([tok]),
                                        torch.tensor([8 + t]))
    raise AssertionError("the continuations differ but every token "
                         "matched when fed")


def test_train_100m_tiny_matches_reference(tmp_path, monkeypatch, capsys):
    from repro_torch.examples import train_100m

    ref = ref_example("train_100m")
    ref_cfg = ref.config_100m()
    ref_cfg = ref_cfg.__class__(**{**ref_cfg.__dict__, **dict(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, vocab_pad_to=32)})
    argv = ["--tiny", "--ckpt-dir", str(tmp_path / "ref")]
    want = run_ref("train_100m", argv, monkeypatch, capsys)
    args = train_100m.parse_args(["--tiny", "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "port")])
    got = train_100m.run(args, params=carried(
        train_100m.tiny(train_100m.config_100m()), ref_cfg))
    out = capsys.readouterr().out
    ref_losses = losses(want)
    assert len(ref_losses) == 3 and len(got) == 20
    np.testing.assert_allclose([got[i]["loss"] for i in (0, 10, 19)],
                               ref_losses, rtol=0, atol=BF16_LOSS_TOL)
    assert out.splitlines()[0] == want.splitlines()[0]
    assert out.splitlines()[-1] == "done; checkpoints: [20]"


def test_elastic_restart_matches_reference(monkeypatch, capsys):
    from repro.configs import get_reduced as ref_reduced
    from repro_torch.configs import get_reduced
    from repro_torch.examples import elastic_restart
    from repro_torch.models import params_from_jax

    want = run_ref("elastic_restart", [], monkeypatch, capsys)
    assert "BIT-EXACT RESUME" in want
    kw = dict(vocab_size=128, vocab_pad_to=32)
    tree = ref_weights(ref_reduced("granite-8b", **kw))
    pcfg = get_reduced("granite-8b", **kw)
    got = elastic_restart.run("cpu", lambda: params_from_jax(
        pcfg, tree, device="cpu", trainable=True))
    out = capsys.readouterr().out
    # the resume is bit-exact: run B's steps equal run A's, bit for bit
    assert got["res_loss"] == got["ref_loss"]
    assert got["b"] == got["a"]
    assert "BIT-EXACT RESUME ✓" in out
    np.testing.assert_allclose([got["ref_loss"], got["res_loss"]],
                               losses(want), rtol=0, atol=BF16_LOSS_TOL)
