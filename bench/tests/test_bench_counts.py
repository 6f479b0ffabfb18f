import pytest

from bench.counts import attention, model, moe, peaks

OLMOE = {"num_hidden_layers": 16, "hidden_size": 2048,
         "intermediate_size": 1024, "num_attention_heads": 16,
         "num_key_value_heads": 16, "head_dim": 128, "num_experts": 64,
         "num_experts_per_tok": 8, "vocab_size": 50304}
GRANITE = {"num_hidden_layers": 36, "hidden_size": 4096,
           "intermediate_size": 14336, "num_attention_heads": 32,
           "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 49152}


def test_flash_by_hand():
    # S = 3 causal: 6 visible pairs; 4·D FLOPs a pair and head
    f, b = attention.flash_prefill(3, H=2, KH=1, D=4)
    assert f == 4 * 4 * 2 * 6
    assert b == 2 * 4 * 3 * (2 * 2 + 2 * 1)


def test_paged_by_hand():
    f, b = attention.paged_decode([5, 7], H=4, KH=2, D=8)
    assert f == 4 * 8 * 4 * 12
    assert b == 2 * 8 * (2 * 2 * 12 + 2 * 4 * 2)


def test_expert_products_by_hand():
    f, b = moe.expert_products(T=10, k=2, D=4, F=3, experts_used=5)
    assert f == 6 * 10 * 2 * 4 * 3
    assert b == 2 * (3 * 5 * 4 * 3 + 10 * 4 + 10 * 2 * 4)


def test_model_step_counts_by_hand():
    # olmoe, one token: projections 2·D·(3·2048) + 2·2048·D, router
    # 2·D·64, 8 experts × 6·D·F; a 1-token prefill sees 1 pair a head
    D, F = 2048, 1024
    lin = 2 * D * 3 * 2048 + 2 * 2048 * D + 2 * D * 64 + 8 * 6 * D * F
    attn = 4 * 128 * 16 * 1
    assert model.prefill_flops(OLMOE, 1) == 16 * (lin + attn) + 2 * D * 50304
    assert model.decode_flops(OLMOE, [1]) == model.prefill_flops(OLMOE, 1)
    # granite's dense GLU and GQA
    D, F = 4096, 14336
    lin = 2 * D * (4096 + 2 * 1024) + 2 * 4096 * D + 6 * D * F
    assert model.decode_flops(GRANITE, [10, 20]) == (
        36 * (2 * lin + 4 * 128 * 32 * 30) + 2 * 2 * D * 49152)


def test_granite_active_params_match_its_size():
    # 2 FLOPs a weight a token, with the tied head once: ~8.05 B weights
    per_token = model.decode_flops(GRANITE, [1]) / 2
    assert per_token == pytest.approx(8.05e9, rel=0.03)


@pytest.mark.parametrize("fn,args", [
    (attention.flash_prefill, (2048, 16, 16, 128)),
    (attention.paged_decode, ([1000, 3000, 17], 32, 8, 128)),
    (moe.expert_products, (2048, 8, 2048, 1024, 64)),
])
def test_no_share_passes_one_at_the_bound(fn, args):
    bound = peaks.roofline_s(*fn(*args))
    for t in (bound, 1.5 * bound, 10 * bound):
        assert bound / t <= 1.0
    flops, bytes_ = fn(*args)
    assert flops / peaks.BF16_FLOPS_PER_S <= bound
    assert bytes_ / peaks.HBM_BYTES_PER_S <= bound


def test_mfu_cannot_pass_one_at_the_peak():
    f = model.prefill_flops(OLMOE, 2048)
    wall = f / peaks.BF16_FLOPS_PER_S
    assert f / (wall * peaks.BF16_FLOPS_PER_S) == pytest.approx(1.0)
