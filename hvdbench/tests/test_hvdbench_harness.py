"""The harness end to end at a tiny size on the CPU: a throwaway cell
added with new files only, the command's refusals, the checks failing
under each fault the cells can have and under the fp8 control, the
contract of ``BENCHMARK.json``, and the modules a run loads.  Tests
marked ``gpu`` run a cell on the card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from hvdbench import compare, run, spec, train, weights
from hvdbench.tests import tiny

REPO = tiny.REPO


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("HOROVOD_RANK", None)
    return env


@pytest.mark.parametrize("task,passes", [("causal_lm", 1), ("masked_lm", 2)])
def test_a_cell_added_with_new_files_runs(tmp_path, task, passes):
    cell = tiny.make(tmp_path, task=task, passes=passes, name="throwaway")
    # the real directory holds none of its files
    assert not (REPO / "hvdbench/configs/throwaway.json").exists()
    c, parts, out = run.run(cell, 1234567, 1.0, False, device="cpu",
                            root=tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "step_ms_p90",
                                   "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    _, _, traced = run.run(cell, 1234567, 1.0, True, device="cpu",
                           root=tmp_path)
    assert traced["correct"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: no per-layer metric is read
    assert traced["metrics"] == {}


def test_same_seed_same_readings(tmp_path):
    cell = tiny.make(tmp_path)
    a = run.run(cell, 42, 0.3, False, device="cpu", root=tmp_path)[1][0]
    b = run.run(cell, 42, 0.3, False, device="cpu", root=tmp_path)[1][0]
    c = run.run(cell, 43, 0.3, False, device="cpu", root=tmp_path)[1][0]
    assert a["program_losses"] == b["program_losses"]
    assert a["program_losses"] != c["program_losses"]


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "hvdbench/run.py", "--workload",
                        "gpt2m.lm1024.1c", "--seed", str(2**31 + 7),
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, env=_env())
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_tree_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "hvdbench", tmp_path / "hvdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cell = tiny.make(tmp_path / "t")
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); "
            f"from hvdbench import run; "
            f"run.run({cell!r}, 1, 0.5, False, device='cpu', "
            f"root={str(tmp_path / 't')!r})")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, env=_env())
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "horovod_tpu_torch" in r.stderr


@pytest.mark.parametrize("fault,ranks,check", [
    ("frozen_step", 1, "delta_gap"),
    ("half_batch", 1, "grad_gap"),
    ("no_exchange", 2, "grad_gap"),
])
def test_each_fault_fails_the_check(tmp_path, fault, ranks, check):
    cell = tiny.make(tmp_path, ranks=ranks)
    _, _, out = run.run(cell, 77, 0.3, False, device="cpu", root=tmp_path,
                        fault=fault)
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"]


def test_the_fp8_control_fails_the_check(tmp_path):
    """The reference with fp8 products in the program's place, against
    the f32 reference, at the tiny size; its gaps are over the tiny
    cell's limits where sound runs are under them."""
    import torch
    cell_name = tiny.make(tmp_path)
    cell = spec.load_cell(cell_name, tmp_path, spec.bench_dirs_for(tmp_path))
    sizes = [weights.numel(s) for s in
             weights.layout(cell.config["model"]).values()]
    for seed in (3, 4):
        args = (cell.config, cell.traffic, seed, torch.device("cpu"))
        ref = train.reference_readings(*args, [0], 1)
        fp8 = train.reference_readings(*args, [0], 1, mode="fp8")
        prog = {"losses": fp8["losses"],
                "grad_norms": compare.leaf_norms(fp8["grad"], sizes),
                "delta": fp8["delta"]}
        ok, _ = compare.verdict(compare.gaps(prog, ref, sizes), cell.limits)
        assert not ok


def test_a_run_loads_no_jax():
    code = ("import sys, json, tempfile\n"
            "from hvdbench import run, train\n"
            "from hvdbench.tests import tiny\n"
            "root = tempfile.mkdtemp()\n"
            "cell = tiny.make(root)\n"
            "run.run(cell, 5, 0.3, False, device='cpu', root=root)\n"
            "print(json.dumps(train.forbidden_modules()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, env=_env(), check=True)
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("horovod_tpu_torch", sys.modules.get(
        "horovod_tpu_torch") or type(sys)("horovod_tpu_torch"))
    assert "horovod_tpu_torch" not in train.forbidden_modules()
    assert [m for m in train.forbidden_modules()
            if m.split(".")[0] == "horovod_tpu_torch"] == []


WIDTH_ENDS = ("_dim", "_rank", "hidden_size", "intermediate_size", "n_embd",
              "n_inner", "head_size")
WIDTH_WORDS = ("latent", "state_size", "proj", "expansion", "per_tok")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["hvdbench"] and 1 <= b["run_seconds"] <= 51
    assert (REPO / b["command"][1]).is_file()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("hvdbench/")
        assert (REPO / c["file"]).is_file() and len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if k.endswith(WIDTH_ENDS)
                    or any(w in k for w in WIDTH_WORDS)]
        names.add(c["name"])
    cells, pairs = set(), []
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (REPO / "hvdbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "hvdbench/limits" / f"{w['name']}.json").is_file()
        four += w["chips"] == 4
        cells.add(w["name"])
        pairs.append((w["config"], w["traffic"]))
    assert len(set(pairs)) == len(pairs)
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        assert (REPO / "hvdbench/metrics" / f"{m['name']}.py").is_file()
        layers.add(m["layer"])
    for w in cells:
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_gpu_cell_runs_correct(gpu):
    r = subprocess.run([sys.executable, "hvdbench/run.py", "--workload",
                        "gpt2m.lm1024.1c", "--seed", str(2**31 + 11),
                        "--seconds", "3", "--trace", "1"], cwd=REPO,
                       capture_output=True, text=True, env=_env(),
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert {"mfu", "flash_roofline", "device_idle_share"} <= \
        set(out["metrics"])
    assert 0 < out["metrics"]["mfu"]["value"] < 100
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


def test_gpu_fp8_control_fails_the_cells_limits(gpu):
    """The control at the cell's own size, one seed (the calibration ran
    three): the fp8 reference in the program's place fails a check."""
    import torch
    cell = spec.load_cell("gpt2m.lm1024.1c")
    sizes = [weights.numel(s) for s in
             weights.layout(cell.config["model"]).values()]
    dev = torch.device("cuda")
    args = (cell.config, cell.traffic, 2**31 + 13, dev)
    ref = train.reference_readings(*args, [0], 1)
    fp8 = train.reference_readings(*args, [0], 1, mode="fp8")
    prog = {"losses": fp8["losses"],
            "grad_norms": compare.leaf_norms(fp8["grad"], sizes),
            "delta": fp8["delta"]}
    ok, checks = compare.verdict(compare.gaps(prog, ref, sizes), cell.limits)
    assert not ok, checks


def test_four_card_cell_runs_the_one_card_mix_on_each_rank():
    """The four-card cell's mix names the one-card mix, and reads as it."""
    one = spec.load_cell("gpt2m.lm1024.1c")
    four = spec.load_cell("gpt2m.lm1024.4c")
    assert (one.chips, four.chips) == (1, 4)
    assert four.traffic_name != one.traffic_name
    assert four.traffic == one.traffic
