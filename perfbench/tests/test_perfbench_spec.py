"""BENCHMARK.json keeps to the contract's shape and rules, and every file it
names is found by name."""
import re

import pytest

import pbsetup  # noqa: F401  (import paths)
from perfbench.bench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_units_and_files():
    assert spec.problems(BENCH) == []


def test_top_level_and_entry_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_and_a_layer_metric(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, trace=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    m = spec.by_name(BENCH["per_layer"], metric, "metric")
    for cell in m["workloads"]:
        assert m["moves"] in [e["name"] for e in spec.metrics_of(BENCH, cell, trace=False)]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_layers_are_perf_md_layers():
    text = (spec.ROOT / "PERF.md").read_text()
    table = re.findall(r"^\| ([^|]+?) \|", text.split("## 3. Layers")[1].split("## 4.")[0], re.M)
    for m in BENCH["per_layer"]:
        assert m["layer"] in table


def test_the_configurations_are_the_ports_at_full_size():
    from repro_torch.configs import get_config
    from repro_torch.models import resnet
    from perfbench.systems import resnet as rsys, transformer as tsys

    cfg = spec.load_json(spec.PKG / "configs" / "minicpm-2b-int8.json")
    ours, port = tsys.model_config(cfg), get_config("minicpm-2b")
    for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "resolved_head_dim",
                "tie_embeddings", "qkv_bias", "block_pattern", "quant"):
        assert getattr(ours, key) == getattr(port, key), key
    # the CIFAR ResNet18: RESNET18's stem, stages and widths, with 10 classes and int8 operands
    r = spec.load_json(spec.PKG / "configs" / "resnet18-cifar-int8.json")
    full = resnet.RESNET18
    assert (r["stem_channels"], tuple(r["stage_channels"]), tuple(r["blocks_per_stage"]), r["input_hw"],
            r["stem_pool"]) == (full.stem_channels, full.stage_channels, full.blocks_per_stage, full.input_hw,
                                full.stem_pool)
    assert (r["num_classes"], r["input_bits"], r["weight_bits"]) == (10, 8, 8)
    tree = resnet._numpy_params(rsys.port_config(r), 0)
    port_shapes = [("stem", tree["stem"].shape)] + [
        (f"s{si}.{bi}.{k}", v.shape) for si, blocks in enumerate(tree["stages"])
        for bi, block in enumerate(blocks) for k, v in block.items()] + [("head", tree["head"].shape)]
    assert sorted(rsys.weight_shapes(r)) == sorted(port_shapes)
