"""The plain reference against the port, at a tiny size on the CPU:
the model's loss and gradients (dense attention, f32 products), and the
checked steps through ``DistributedOptimizer`` in gloo worlds of one and
of two."""

import json
import subprocess
import sys

import pytest
import torch

from hvdbench import compare, run, weights
from hvdbench.reference import transformer as ref_model
from hvdbench.reference.products import Products
from hvdbench.tests import tiny

MODEL = {"vocab_size": 256, "num_layers": 2, "num_heads": 2, "d_model": 128,
         "d_ff": 256, "max_len": 32, "block_ln_eps": 1e-5,
         "final_ln_eps": 1e-6}
INIT = {"kernel_std": 0.02, "token_embedding_std": 0.02,
        "position_embedding_std": 0.01}


def _port(causal):
    from horovod_tpu_torch.models import transformer as T
    m = dict(MODEL, causal=causal)
    cfg = T.TransformerConfig(
        vocab_size=m["vocab_size"], num_layers=m["num_layers"],
        num_heads=m["num_heads"], d_model=m["d_model"], d_ff=m["d_ff"],
        max_len=m["max_len"], causal=causal, dtype=torch.float32,
        attention_impl=None)
    model = T.Transformer(cfg, device="cpu")
    w = weights.make({"model": m, "init": INIT}, 11, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return T, model, m, w


def _compare_grads(model, P):
    for n, p in model.named_parameters():
        scale = max(float(P[n].grad.norm()), 1e-12)
        assert float((p.grad - P[n].grad).norm()) / scale < 2e-5, n


def test_causal_lm_loss_and_gradients_match_the_port():
    T, model, m, w = _port(True)
    tokens = torch.randint(0, 256, (3, 32),
                           generator=torch.Generator().manual_seed(1))
    loss = T.lm_loss(model(tokens)[:, :-1], tokens[:, 1:])
    loss.backward()
    P = {n: t.clone().requires_grad_() for n, t in w.items()}
    ce, n = ref_model.loss_sum(P, m, "causal_lm", {"tokens": tokens},
                               Products())
    (ce / n).backward()
    assert float(ce.detach() / n) == pytest.approx(float(loss.detach()),
                                                   rel=1e-6)
    _compare_grads(model, P)


def test_masked_lm_loss_and_gradients_match_the_port():
    T, model, m, w = _port(False)
    g = torch.Generator().manual_seed(2)
    inputs = torch.randint(5, 256, (3, 32), generator=g)
    positions = torch.rand((3, 32), generator=g).argsort(-1)[:, :6]
    positions = positions.sort(-1).values
    labels = torch.randint(5, 256, (3, 6), generator=g)
    loss = T.lm_loss(model(inputs, predict_positions=positions), labels)
    loss.backward()
    P = {n: t.clone().requires_grad_() for n, t in w.items()}
    batch = {"inputs": inputs, "positions": positions, "labels": labels}
    ce, n = ref_model.loss_sum(P, m, "masked_lm", batch, Products())
    (ce / n).backward()
    assert float(ce.detach() / n) == pytest.approx(float(loss.detach()),
                                                   rel=1e-6)
    _compare_grads(model, P)


def test_layout_is_the_ports():
    T, model, m, _ = _port(True)
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        list(weights.layout(m).items())


def test_weights_come_from_the_seed():
    cfg = {"model": dict(MODEL, causal=True), "init": INIT}
    a, b = weights.make(cfg, 5, "cpu"), weights.make(cfg, 5, "cpu")
    c = weights.make(cfg, 6, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wte.embedding"], c["wte.embedding"])
    assert float(a["ln_f.scale"].min()) == 1.0
    assert float(a["blocks.0.fc1.bias"].abs().max()) == 0.0
    assert float(a["wte.embedding"].std()) == pytest.approx(0.02, rel=0.05)
    assert float(a["wpe.embedding"].std()) == pytest.approx(0.01, rel=0.1)


@pytest.mark.parametrize("task,ranks,passes", [
    ("causal_lm", 1, 1), ("masked_lm", 1, 2), ("causal_lm", 2, 1),
    ("causal_lm", 4, 1)])
def test_checked_steps_match_the_reference_in_f32(tmp_path, task, ranks,
                                                  passes):
    """f32 products and dense attention on both sides: the gaps are
    rounding, far under the bf16 cells' limits.  Two and four ranks are
    gloo worlds started through the port's launcher, as the four-card
    cell starts."""
    cell = tiny.make(tmp_path, task=task, ranks=ranks, passes=passes,
                     dtype="float32", attention="dense",
                     limits={"loss_gap": 1e-5, "grad_gap": 1e-4,
                             "delta_gap": 1e-4})
    _, parts, out = run.run(cell, 2**31 + 5, 0.5, False, device="cpu",
                            root=tmp_path)
    assert out["correct"], out["checks"]
    assert len(parts) == ranks
    assert out["device"]["count"] == ranks


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; import hvdbench.reference.train, "
            "hvdbench.reference.transformer, hvdbench.reference.products; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('horovod_tpu_torch', 'horovod_tpu', 'jax', 'jaxlib', 'flax', "
            "'optax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_gaps_measure_the_worst_leaf():
    sizes = [4, 4, 2]
    ref = {"losses": {0: [2.0, 1.0]},
           "grad": torch.tensor([1., 1, 1, 1, 2, 2, 2, 2, 0, 0]),
           "delta": torch.tensor([1., 1, 1, 1, 1, 1, 1, 1, 1, 1])}
    prog = {"losses": {0: [2.0, 1.1]},
            "grad_norms": torch.tensor([2.0, 4.4, 0.0], dtype=torch.float64),
            "delta": torch.tensor([1., 1, 1, 1, 1, 1, 1, 1, 5, 5])}
    g = compare.gaps(prog, ref, sizes)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_gap"] == pytest.approx(0.1)      # 4.4 vs 4.0
    # the last leaf's gradient is zero: its change is left out
    assert g["delta_gap"] == pytest.approx(0.0)
    ok, checks = compare.verdict(g, {"loss_gap": {"limit": 0.2},
                                     "grad_gap": {"limit": 0.05},
                                     "delta_gap": {"limit": 0.1}})
    assert not ok and checks["grad_gap"] == {"value": g["grad_gap"],
                                             "limit": 0.05}
