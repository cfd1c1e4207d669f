"""The operations and bytes the benchmark counts, against values worked
by hand for both configurations."""

import json

import pytest

from hvdbench import roofline
from hvdbench.tests.tiny import REPO


def _load(config, traffic):
    c = json.loads((REPO / "hvdbench/configs" / f"{config}.json").read_text())
    t = json.loads((REPO / "hvdbench/traffic" / f"{traffic}.json").read_text())
    return c["model"], t


def test_gpt2_medium_step_flops():
    model, traffic = _load("gpt2-medium", "lm1024")
    # blocks: 24 * 12 * 1024^2 = 301,989,888; head 50257 * 1024
    blocks, head = roofline.matmul_params(model)
    assert (blocks, head) == (301_989_888, 51_463_168)
    per_token = 6 * (blocks + head) + 12 * 24 * 1024 * 1024 * 0.5
    assert roofline.step_flops(model, traffic) == pytest.approx(
        32 * 1024 * per_token, rel=1e-12)
    assert per_token == pytest.approx(2.2717e9, rel=1e-4)


def test_bert_large_step_flops():
    model, traffic = _load("bert-large", "mlm128")
    blocks, head = roofline.matmul_params(model)
    assert (blocks, head) == (301_989_888, 31_254_528)
    rows = 128 * 2
    want = rows * (128 * (6 * blocks + 12 * 24 * 128 * 1024)
                   + 20 * 6 * head)
    assert roofline.step_flops(model, traffic) == pytest.approx(want,
                                                                rel=1e-12)
    assert want / rows / 128 == pytest.approx(1.879e9, rel=1e-3)


def test_flash_work_by_hand():
    # GPT-2 medium's launch: [32, 1024, 16, 64] bf16, causal
    B, S, H, D = 32, 1024, 16, 64
    t = B * S * H * D * 2
    row = B * H * S * 4
    pairs = S * (S + 1) // 2
    w = roofline.flash_work(B, S, H, D, True)
    assert w["flash_fwd"] == (4 * t + row, 2 * 2 * D * pairs * B * H)
    assert w["flash_bwd_dq"] == (5 * t + 2 * row, 3 * 2 * D * pairs * B * H)
    assert w["flash_bwd_dkv"] == (6 * t + 2 * row, 4 * 2 * D * pairs * B * H)
    # BERT-large's: [128, 128, 16, 64], every pair kept
    w = roofline.flash_work(128, 128, 16, 64, False)
    assert w["flash_fwd"][1] == 2 * 2 * 64 * 128 * 128 * 128 * 16


def test_flash_bounds_pick_the_larger_time():
    model, traffic = _load("gpt2-medium", "lm1024")
    b = roofline.flash_bounds_s(model, traffic, 989e12, 3.35e12)
    nbytes, ops = roofline.flash_work(32, 1024, 16, 64, True)["flash_fwd"]
    assert b["flash_fwd"] == max(nbytes / 3.35e12, ops / 989e12)
    assert b["flash_fwd"] == nbytes / 3.35e12  # bytes bound at D = 64
    nbytes, ops = roofline.flash_work(32, 1024, 16, 64, True)["flash_bwd_dkv"]
    assert b["flash_bwd_dkv"] == ops / 989e12  # operations bound
    model, traffic = _load("bert-large", "mlm128")
    b = roofline.flash_bounds_s(model, traffic, 989e12, 3.35e12)
    nbytes, ops = roofline.flash_work(128, 128, 16, 64, False)["flash_fwd"]
    assert b["flash_fwd"] == max(nbytes / 3.35e12, ops / 989e12)


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::flash_fwd_kernel<64, 128>(Params)", "flash_fwd"),
    ("void (anonymous namespace)::dq_kernel<64>(BwdParams)", "flash_bwd_dq"),
    ("void (anonymous namespace)::dkv_kernel<64>(BwdParams)", "flash_bwd_dkv"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", None),
])
def test_flash_kernel_names(name, kernel):
    assert roofline.flash_kernel_of(name) == kernel
