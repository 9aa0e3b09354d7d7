"""The attribution of a traced window to the port's spans
(``perfbench/bench/program_trace.py``) on synthetic event lists, and the
recorded run of ``perfbench/trace_program.py`` on the CPU at a tiny size."""
import sys
import time

import pytest
import torch

import pbsetup
from perfbench.bench import harness
from perfbench.bench import program_trace as pt
from perfbench.bench.trace import WINDOW

sys.path.insert(0, str(pbsetup.ROOT / "perfbench"))
try:
    import trace_program
finally:
    sys.path.remove(str(pbsetup.ROOT / "perfbench"))

E = pt.Event


def host(name, a, b, corr=0):
    return E(name, a, b, device=False, thread=1, corr=corr)


def dev(name, a, b, corr=0, annotation=False):
    return E(name, a, b, device=True, thread=7, corr=corr, annotation=annotation)


def window(*events):
    return [host(WINDOW, 0, 100), *events]


def test_a_gap_goes_to_the_innermost_program_range_not_to_an_op_or_runtime_call_inside_it():
    events = window(
        host("repro_torch.program.call", 10, 60),
        host("repro_torch.program.replay", 20, 50),
        host("cudaGraphLaunch", 22, 48, corr=5),
        host("aten::copy_", 52, 58),
        host("perfbench.batch", 5, 95),
        dev("gemm", 40, 45, corr=5),
        dev("gemm", 70, 100, corr=5),
    )
    got = pt.attribute(events)
    # gaps: 0-40 (mid 20: program.replay), 45-70 (mid 57.5: program.call, not aten::copy_)
    assert got.idle_us == {"program.replay": 40.0, "program.call": 25.0}
    assert got.idle_under("program.") == 65.0
    assert pt.program_idle_us(got, 1) == 65.0 and pt.executor_host_us([50.0, 70.0, 10.0]) == 50.0
    assert pt.executor_host_us([]) is None


def test_a_gap_outside_every_program_range_goes_to_none():
    got = pt.attribute(window(host("perfbench.batch", 0, 100), host("aten::add", 10, 20)))
    assert got.idle_us == {pt.NONE: 100.0}
    assert pt.program_idle_us(got, 1) is None and pt.engine_idle_ms(got, 1) is None


def test_a_kernel_goes_to_the_range_around_its_launch():
    events = window(
        host("repro_torch.serve.run", 0, 100),
        host("repro_torch.serve.prefill", 1, 90),
        host("repro_torch.model.act_quant", 2, 10),
        host("cudaLaunchKernel", 3, 4, corr=11),
        host("repro_torch.model.attention", 20, 30),
        host("cudaLaunchKernel", 21, 22, corr=12),
        host("cudaLaunchKernel", 40, 41, corr=13),
        host("aten::mul", 50, 52, corr=14),  # an op's own id is no launch
        dev("absmax", 30, 35, corr=11),      # runs after its range closed: still act_quant's
        dev("softmax", 35, 55, corr=12),
        dev("bitslice_mma", 55, 60, corr=13),
        dev("elementwise", 60, 62, corr=14),
    )
    got = pt.attribute(events)
    assert got.device_us == {"model.act_quant": 5.0, "model.attention": 20.0, "serve.prefill": 5.0, pt.NONE: 2.0}
    assert pt.device_ms(got, "model.attention", 2) == 0.01
    assert pt.device_ms(got, "model.dequant", 2) is None
    # idle 0-30 (midpoint 15, between act_quant and attention) and 62-100: serve.prefill's
    assert got.idle_us == {"serve.prefill": 68.0}
    assert pt.engine_idle_ms(got, 2) == 0.034


def test_a_shadow_of_a_range_on_the_device_counts_as_no_operation():
    events = window(
        host("repro_torch.program.replay", 10, 20),
        host("cudaGraphLaunch", 11, 12, corr=3),
        dev("repro_torch.program.replay", 12, 90, corr=3, annotation=True),
        dev("repro_torch.program.call", 12, 90, corr=3),  # a shadow the profiler did not flag
        dev("perfbench.batch", 12, 90),
        dev("k", 30, 40, corr=3),
    )
    got = pt.attribute(events)
    assert got.shadows == 3
    assert got.device_us == {"program.replay": 10.0, pt.NONE: 0}
    assert sum(got.idle_us.values()) == 90.0


def test_ranges_of_other_threads_and_outside_the_window_are_not_read():
    events = window(
        E("repro_torch.program.call", 0, 100, thread=2),
        host("repro_torch.program.call", 150, 160),
    )
    got = pt.attribute(events)
    assert got.ranges == [] and got.idle_us == {pt.NONE: 100.0}
    with pytest.raises(RuntimeError):
        pt.attribute([host("x", 0, 1)])


def test_engine_pad_share_reads_the_counters():
    assert pt.engine_pad_share({"serve.prompt_slots": 40, "serve.padding_slots": 10}) == 25.0
    assert pt.engine_pad_share({}) is None


@pytest.mark.parametrize("cell", ["resnet18.b32", "minicpm-2b.prefill-512"])
def test_a_recorded_traced_run_on_the_cpu(cell):
    resnet = cell.startswith("resnet")
    cfg = pbsetup.tiny_resnet() if resnet else pbsetup.tiny_transformer()
    tr = pbsetup.tiny_images() if resnet else pbsetup.tiny_prompts()
    lim = {"logits_mismatched": 0} if resnet else {"served_gap_max": 1.0, "logit_err_max": 1.0}
    with trace_program.recording(harness) as kept:
        r = harness.run_cell(cell, 5, 0.2, True, torch.device("cpu"), t0=time.perf_counter(), config=cfg,
                             traffic=tr, limits=lim, log=lambda m: None)
    assert r["correct"]
    line = trace_program.program_line(kept)
    got = line["readings"]
    assert line["batches"] == tr["trace_batches"]
    if resnet:
        assert got["executor_host_us"] > 0 and got["engine_pad_share"] is None
        assert line["profiled_span_us"]["program.call"][0] == tr["trace_batches"]
    else:
        # the engine's own counters read what the harness's wrapper of prompt_batch reads
        assert got["engine_pad_share"] == r["metrics"]["pad_share.llm"]["value"]
        assert got["executor_host_us"] is None
    assert (harness._profile.__name__, harness.summarize.__name__) == ("_profile", "summarize")  # restored
