"""Fault-tolerance demo: train, checkpoint asynchronously, 'crash',
restore, and continue — bit-exact vs an uninterrupted run (the JAX
package's ``examples/elastic_restart.py`` on the port). The same
checkpoints restore onto any mesh (``restore(..., shardings=)`` places
the whole arrays by this run's specs), which is the elastic-restart
path across cards.

  PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.kernels.fleet import check_device
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import init_train_state, make_train_step


def run(device="cuda", fresh_params=None) -> dict:
    """Run A (8 uninterrupted steps) against run B (4 steps, an async
    checkpoint each step, a restore into a fresh state, 4 more), each
    from ``fresh_params()`` (new trainable weights, e.g. carried from
    the reference) or weights drawn from seed 0. Returns both runs'
    per-step total losses and the two final ones."""
    dev = check_device(device)
    cfg = get_reduced("granite-8b", vocab_size=128, vocab_pad_to=32)
    model = build_model(cfg, device=dev, trainable=True)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0)
    shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
    pipe = make_pipeline(cfg, shape, seed=0)
    step_fn = make_train_step(model, tc)

    def fresh():
        return init_train_state(
            model, 0, params=None if fresh_params is None else fresh_params())

    out = {"a": [], "b": []}
    with tempfile.TemporaryDirectory() as d:
        # ---- run A: uninterrupted 8 steps
        state = fresh()
        for i in range(8):
            state, m = step_fn(state, to_device(pipe.batch(i), dev))
            out["a"].append(float(m["total_loss"]))
        ref_loss = out["a"][-1]
        print(f"uninterrupted: loss@8 = {ref_loss:.6f}")

        # ---- run B: crash after 4, async checkpoint, restore, resume
        state = fresh()
        writer = None
        for i in range(4):
            state, m = step_fn(state, to_device(pipe.batch(i), dev))
            out["b"].append(float(m["total_loss"]))
            if writer:
                writer.join()
            writer = ckpt.save(d, i + 1, state, async_=True)  # overlapped I/O
        writer.join()
        print(f"'crash' at step 4 (committed: {ckpt.latest_steps(d)})")

        template = fresh()
        start, state = ckpt.restore(d, template)
        print(f"restored step {start}; resuming (deterministic pipeline "
              f"regenerates batch {start} exactly)")
        for i in range(start, 8):
            state, m = step_fn(state, to_device(pipe.batch(i), dev))
            out["b"].append(float(m["total_loss"]))
        res_loss = out["b"][-1]
        print(f"resumed:       loss@8 = {res_loss:.6f}")
        if not abs(res_loss - ref_loss) < 1e-6 * max(abs(ref_loss), 1):
            raise RuntimeError(f"resumed loss {res_loss} differs from the "
                               f"uninterrupted {ref_loss}")
        print("BIT-EXACT RESUME ✓")
    out.update(ref_loss=ref_loss, res_loss=res_loss)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
