"""The benchmark finds everything by name, takes a new cell, mix,
configuration or metric as files and entries alone, prints the contract's
result line, and imports neither JAX nor the JAX package."""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.harness import ROOT, Outcome, load_cell, metrics_of, per_layer, result_line
from portbench.tests.tiny import run_tiny
from portbench.trace import Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PORTBENCH = ROOT / "portbench"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench, work, config, traffic, limits = load_cell(cell)
    assert config["name"] == work["config"] and traffic["name"] == work["traffic"]
    assert (PORTBENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert limits["limits"]
    for kind in ("end_to_end", "per_layer"):
        assert metrics_of(bench, work, kind), f"{cell} reports no {kind} metric"
    for m in metrics_of(bench, work, "per_layer"):
        reader = harness.load_module(harness.reader_path(m["name"]), "reader")
        empty = {"trace": None, "videos": [], "steps": 0, "ef_s": [], "config": config,
                 "traffic": traffic}
        assert reader.read(empty) is None


def test_each_configuration_is_used_and_names_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        assert conf["name"] in used
        config = json.loads((ROOT / conf["file"]).read_text())
        assert config["name"] == conf["name"]
        # What departs from the source is listed, in both places, and is no width.
        assert conf["reduced"] == config["reduced"]
        for key in conf["reduced"]:
            assert key in config and not key.endswith(("_dim", "_rank", "_width", "_widths"))


def _copy_checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_cell_mix_config_and_metric_are_files_and_entries_alone(tmp_path):
    root = _copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "clasfv-r2p1d18-fp32.json").read_text())
    (pb / "configs" / "clasfv-new.json").write_text(json.dumps({**config, "name": "clasfv-new"}))
    traffic = json.loads((pb / "traffic" / "train-b4.json").read_text())
    (pb / "traffic" / "train-b2.json").write_text(
        json.dumps({**traffic, "name": "train-b2", "batch": 2}))
    (pb / "limits" / "new-b2.json").write_text(json.dumps(
        {"limits": {"loss_gap": 0.05, "grad_gap": 0.015, "change_gap": 0.2}}))
    (pb / "metrics" / "busy_ms.new.py").write_text(
        "def read(ctx):\n    return None if ctx['trace'] is None else 1e3 * ctx['trace'].busy_s()\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "clasfv-new", "source": "a paper", "file":
                             "portbench/configs/clasfv-new.json", "reduced": [], "why": "new"})
    bench["workloads"].append({"name": "new-b2", "config": "clasfv-new",
                               "traffic": "train-b2", "chips": 1, "why": "new"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("new-b2")
    bench["per_layer"].append({"name": "busy_ms.new", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_step_ms", "workloads": ["new-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench, work, config, traffic, limits = load_cell("new-b2", root)
    assert (config["name"], traffic["batch"]) == ("clasfv-new", 2)
    assert [m["name"] for m in metrics_of(bench, work, "per_layer")] == ["busy_ms.new"]
    trace = Trace([("k", 0.0, 2000.0)], [], (0.0, 4000.0), 0.004)
    got = per_layer(bench, work, Outcome(1, 0, {}, {}, context={"trace": trace}), root)
    assert got == {"busy_ms.new": {"value": 2.0, "unit": "ms"}}
    changed = [p for p, data in before.items() if p.read_bytes() != data]
    assert changed == [root / "BENCHMARK.json"]


def test_a_quantity_split_by_cells_is_read_by_the_quantitys_reader(tmp_path):
    root = _copy_checkout(tmp_path)
    (root / "portbench" / "metrics" / "busy_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx['trace'].busy_s()\n")
    assert harness.reader_path("busy_ms.train.bf16", root).name == "busy_ms.py"
    assert harness.reader_path("mfu.train.bf16").name == "mfu.train.py"
    assert harness.reading({"train_step_ms": 80.0}, "train_step_ms.bf16") == 80.0
    assert harness.reading({"train_step_ms": 80.0}, "frames_per_s") is None
    bench, work, config, traffic, _ = load_cell("bf16-train", root)
    bench["per_layer"].append({"name": "busy_ms.train.bf16", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_step_ms.bf16", "workloads": ["bf16-train"]})
    trace = Trace([("k", 0.0, 2000.0)], [], (0.0, 4000.0), 0.004)
    ctx = {"trace": trace, "config": config, "traffic": traffic, "steps": 1,
           "step_flops": 1e9, "peak_flops": 989e12, "window_s": 0.004}
    got = per_layer(bench, work, Outcome(1, 0, {}, {}, context=ctx), root)
    assert got["busy_ms.train.bf16"] == {"value": 2.0, "unit": "ms"}
    assert "mfu.train.bf16" in got and "mfu.train" not in got


@pytest.mark.parametrize("reader", ["conv_ms_per_step.train", "conv_ms_per_clip.archive"])
def test_the_conv_readers_take_convs_and_leave_batchnorm_layout_and_conversions(reader):
    conv = harness.load_module(PORTBENCH / "metrics" / f"{reader}.py", "reader").is_conv
    for name in ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw",
                 "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwc",
                 "void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int>",
                 "void wgrad_alg1_nd_float_engine<float, float, 3, 0, 5, 7, 4>"):
        assert conv(name), name
    for name in ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>",
                 "void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512>",
                 "void at::native::batch_norm_backward_kernel<c10::BFloat16, float>",
                 "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
                 "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>",
                 "void cudnn::engines_precompiled::convertTensor_kernel<float, __nv_bfloat16>"):
        assert not conv(name), name
    # The train step's GEMMs (the decoder's, and the weight-gradient GEMM route) count there.
    assert conv("nvjet_tst_64x512_64x2_1x2_h_bz_coopB_TNT") == reader.endswith(".train")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = list(PORTBENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("echoflow_torch", *harness.FORBIDDEN), f"{path} imports {name}"
            assert not name.startswith("portbench.") or name.startswith("portbench.reference"), \
                f"{path} imports {name}"


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_the_last_line_holds_the_contracts_keys():
    rc, line, err = run_tiny("fp32-archive")
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "video_p95_ms", "peak_reserved_gib",
                                    "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["checks"]) == {"mask_diff_share", "ef_mismatch"}
    last = err.strip().splitlines()[-2:]
    assert [s.split(":")[0] for s in last] == ["check mask_diff_share", "check ef_mismatch"]


def test_a_traced_line_adds_the_breakdown_and_the_per_layer_metrics():
    bench, work, config, traffic, limits = load_cell("fp32-train")
    trace = Trace([(f"kernel{i}", 100.0 * i, 100.0 * i + 60.0) for i in range(30)],
                  [("portbench.step", 1, 0.0, 3000.0)], (0.0, 3000.0), 0.003)
    ctx = {"trace": trace, "config": config, "traffic": traffic, "steps": 2,
           "step_flops": 1e9, "peak_flops": 67e12, "window_s": 0.003}
    outcome = Outcome(2, 0, {}, {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0},
                      context=ctx, trace=trace)
    device = {"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 1,
              "busy_s": trace.busy_s(), "window_s": trace.window_s()}
    line = result_line(bench, work, outcome, limits, True, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) == 10 for v in line["breakdown"].values())
    assert line["breakdown"]["idle_gaps"][0] == ["portbench.step", pytest.approx(40e-6)]
    assert line["metrics"]["device_idle_pct.train"]["value"] == pytest.approx(40.0)
    assert line["metrics"]["mfu.train"]["value"] == pytest.approx(100 * 2e9 / (0.003 * 67e12))
    assert "warp_roofline_pct" not in line["metrics"]     # no warp kernel in this trace


def test_cuda_is_required_when_there_is_no_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.run(["--workload", "fp32-train", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
