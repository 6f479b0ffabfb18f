"""The launcher over DTensors for every family but the dense decoder
(``test_torch_distributed.py`` has reduced tinyllama-1.1b): reduced
olmoe-1b-7b and arctic-480b (the MoE routes the whole batch, its experts
split over "model"), rwkv6-3b (its mix LoRA gathered over "model" before
the split into five), zamba2-2.7b, whisper-small and llava-next-34b, and
tinyllama-1.1b with one KV head (whole keys on each model rank, whose
gradients there are summed across the ranks), in
f32 at a learning rate of 1e-2 on 2 gloo ranks, on the host mesh (1, 2)
and on the data-parallel mesh (2, 1), each spawn within its own time
limit: 2 steps, each total loss within 1e-5 (relative) of the same
launcher on one rank in this process (no process group)."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_ranks as TR  # noqa: E402

LOSS_RTOL = 1e-5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-small",
                                  "llava-next-34b", "tinyllama-1.1b:1"])
def test_launcher_on_2_ranks_matches_1_rank(arch, tmp_path):
    ranks = TR.spawn("family", 2, tmp_path, args=(arch,))
    name, overrides = TR.family_overrides(arch)
    with TR.f32_launcher(**overrides) as lt:
        one = lt.train(TR.launcher_args(arch=name, steps=2),
                       lt.meshes.make_host_mesh("cpu"))
    want = [m["total_loss"] for m in one]
    for r in ranks:
        for tag in ("host", "data"):
            np.testing.assert_allclose(r[f"{tag}_loss"], want,
                                       rtol=LOSS_RTOL, atol=0)
