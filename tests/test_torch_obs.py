"""The port's spans and counters (``repro_torch.obs``) on the CPU.

Span recording is off by default and switched by ``obs.enable()`` /
``obs.disable()``; counters are always on and hold the kernel wrappers'
launch counters as ``launch.<kernel>``.  The graph route of the Executor is
driven through the ``_CudaGraph`` fake of ``tests/test_torch_executor_replay.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from test_torch_executor_replay import LAUNCHES, executor, fake_graphs, operands, want  # noqa: E402,F401


@pytest.fixture(autouse=True)
def recording_off():
    obs.disable()
    yield
    obs.disable()


def test_off_records_nothing_and_returns_one_shared_null():
    obs.enable()
    obs.disable()
    assert not obs.recording()
    a, b = obs.span("x"), obs.call("y", call=3)
    assert a is b is obs.NULL
    with a as inner:
        inner.note("route", "graph")
        with b:
            pass
    assert obs.record().spans == [] and obs.record().dropped == 0


def test_on_spans_nest_with_their_parent_and_share_the_call_id():
    obs.enable()
    assert obs.recording()
    with obs.call("outer", batch=7) as outer:
        with obs.span("a"):
            with obs.span("b"):
                pass
        with obs.call("inner_call", program="p"):
            with obs.span("c"):
                pass
        outer.note("route", "graph")
    with obs.span("loose"):
        pass
    rec = obs.record()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["outer", "a", "b", "inner_call", "c", "loose"]
    assert [s.seq for s in rec.spans] == list(range(6))
    assert by["outer"].parent == -1 and by["a"].parent == by["outer"].seq and by["b"].parent == by["a"].seq
    assert by["inner_call"].parent == by["outer"].seq and by["c"].parent == by["inner_call"].seq
    # a call's opening span: its seq is the call id of the spans inside it
    assert by["outer"].call == by["a"].call == by["b"].call == by["outer"].seq
    assert by["inner_call"].call == by["c"].call == by["inner_call"].seq
    assert by["loose"].call == -1 and by["loose"].parent == -1
    assert rec.calls == {by["outer"].seq: {"batch": 7, "route": "graph"}, by["inner_call"].seq: {"program": "p"}}
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns
    assert by["outer"].start_ns <= by["a"].start_ns and by["c"].end_ns <= by["outer"].end_ns
    assert rec.dropped == 0


def test_the_record_drops_its_oldest_spans_at_capacity_and_counts_them(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 4)
    obs.enable()
    for i in range(5):
        with obs.call("call", i=i):
            with obs.span("part"):
                pass
    rec = obs.record()
    assert rec.dropped == 6
    assert [(s.seq, s.name) for s in rec.spans] == [(6, "call"), (7, "part"), (8, "call"), (9, "part")]
    assert rec.calls == {6: {"i": 3}, 8: {"i": 4}}  # the ids of dropped calls went with them
    monkeypatch.setattr(obs, "CAPACITY", 2)
    obs.enable()  # a fresh record
    assert obs.record().spans == [] and obs.record().dropped == 0
    monkeypatch.setattr(obs, "CAPACITY", 0)
    with pytest.raises(ValueError):
        obs.enable()


def test_a_span_whose_slot_is_taken_while_open_is_dropped_not_misrecorded(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 2)
    obs.enable()
    with obs.span("long"):
        for _ in range(3):
            with obs.span("short"):
                pass
    rec = obs.record()
    assert [s.name for s in rec.spans] == ["short", "short"] and rec.dropped == 2


def test_launch_counts_keep_their_behaviour_beside_other_counters():
    tapi.reset_launch_counts()
    obs.reset_counts("test.")
    tapi.count_launch("relu")
    tapi.count_launch("relu")
    obs.count("test.slots", 5)
    assert tapi.launch_counts() == {"relu": 2}
    assert obs.counts("launch.") == {"launch.relu": 2} and obs.counts("test.") == {"test.slots": 5}
    tapi.reset_launch_counts()
    assert tapi.launch_counts() == {} and obs.counts("test.") == {"test.slots": 5}
    obs.reset_counts("test.")
    assert obs.counts("test.") == {}


def test_a_counter_taken_inside_a_graph_capture_is_added_at_each_replay(fake_graphs, monkeypatch):
    ops = operands(3)
    ex = executor(ops)
    dispatch = tapi.dispatch

    def counting(name, *args, **kwargs):
        out = dispatch(name, *args, **kwargs)
        obs.count("test.ops")
        return out

    monkeypatch.setattr(tapi, "dispatch", counting)
    tapi.reset_launch_counts()
    obs.reset_counts("test.")
    ex(*ops)  # eager run, then the capture: the capture's counts go to its log
    assert obs.counts("test.") == {"test.ops": 3} and tapi.launch_counts() == LAUNCHES
    (replay,) = ex._graphs.values()
    assert replay.log.taken == {"test.ops": 3, **{"launch." + k: n for k, n in LAUNCHES.items()}}
    assert replay.log.counts == LAUNCHES
    for _ in range(2):
        assert torch.equal(ex(*ops), want(*ops))
    assert obs.counts("test.") == {"test.ops": 9}
    assert tapi.launch_counts() == {k: 3 * n for k, n in LAUNCHES.items()}
    obs.reset_counts("test.")


def test_executor_spans_by_route(fake_graphs):
    ops = operands(4)
    ex = executor(ops)
    obs.enable()
    for _ in range(3):
        ex(*ops)
    rec = obs.record()
    calls = rec.named("program.call")
    assert len(calls) == 3
    names = {c.seq: [s.name for s in rec.spans if s.parent == c.seq] for c in calls}
    assert list(names.values()) == [["program.check", "program.eager", "program.capture"],
                                    ["program.check", "program.copy_in", "program.replay", "program.copy_out"],
                                    ["program.check", "program.copy_in", "program.replay", "program.copy_out"]]
    assert [rec.calls[c.seq] for c in calls] == [{"program": "replay_chain", "route": "graph"}] * 3
    for c in calls:  # every span of a call carries its call id
        assert {s.call for s in rec.spans if s.parent == c.seq} == {c.seq}


def _tiny_engine():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    params = tt.init_params(cfg, seed=0, device="cpu")
    return cfg, tengine.ServeEngine(cfg, params, max_len=32)


def _requests(cfg, lengths, new_tokens):
    rng = np.random.default_rng(11)
    return [tengine.Request(rid=10 + i, prompt=rng.integers(2, cfg.vocab_size, n).astype(np.int32),
                            max_new_tokens=new_tokens) for i, n in enumerate(lengths)]


def test_serve_engine_spans_and_pad_counters(monkeypatch):
    cfg, engine = _tiny_engine()
    lengths = (3, 12, 9)
    reqs = _requests(cfg, lengths, 3)
    obs.reset_counts("serve.")
    obs.enable()
    engine.run(reqs)
    obs.disable()
    # the benchmark's own count of a batch's padding (perfbench/systems/transformer.py)
    b, s = len(lengths), max(max(lengths), 8)
    assert obs.counts("serve.") == {"serve.prompt_slots": b * s, "serve.padding_slots": b * s - sum(lengths)}
    rec = obs.record()
    (run,) = rec.named("serve.run")
    assert rec.calls[run.seq] == {"requests": (10, 11, 12)}
    top = [s.name for s in rec.spans if s.parent == run.seq]
    assert top == ["serve.prompt_batch", "serve.prefill", "serve.sample",
                   "serve.decode", "serve.sample", "serve.decode", "serve.sample"]
    assert {s.call for s in rec.spans} == {run.seq}
    prefill = rec.named("serve.prefill")[0]
    inside = [s for s in rec.spans if prefill.start_ns <= s.start_ns and s.end_ns <= prefill.end_ns]
    n_linear = cfg.n_layers * 7 + (0 if cfg.tie_embeddings else 1)
    assert sum(s.name == "model.attention" for s in inside) == cfg.n_layers
    assert sum(s.name == "model.act_quant" for s in inside) >= n_linear
    # every linear dequantizes in the GEMM's epilogue: no dequantize left outside it
    assert sum(s.name == "model.dequant" for s in inside) == 0
    assert all(r.generated and len(r.generated) == 3 for r in reqs)
    # the PyTorch dequantize, where the epilogue does not take a product, has a span a linear
    monkeypatch.setattr(tapi, "dequant_matmul_takes", lambda *a: False)
    obs.enable()
    engine.run(_requests(cfg, lengths, 1))
    obs.disable()
    rec = obs.record()
    prefill = rec.named("serve.prefill")[0]
    inside = [s for s in rec.spans if prefill.start_ns <= s.start_ns and s.end_ns <= prefill.end_ns]
    assert sum(s.name == "model.dequant" for s in inside) == sum(s.name == "model.act_quant" for s in inside)


def test_off_the_engine_counts_but_records_no_span():
    cfg, engine = _tiny_engine()
    obs.enable()
    obs.disable()
    obs.reset_counts("serve.")
    engine.run(_requests(cfg, (5, 9), 1))
    assert obs.record().spans == []
    assert obs.counts("serve.") == {"serve.prompt_slots": 18, "serve.padding_slots": 4}


def _ranges(prof):
    """(name, innermost enclosing ``repro_torch.`` range's name) of each
    ``repro_torch.`` range of the profile, in order of start."""
    out = []
    for e in sorted(prof.events(), key=lambda e: (e.time_range.start, -e.time_range.end)):
        if not e.name.startswith(obs.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(obs.PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(obs.PREFIX):], p.name[len(obs.PREFIX):] if p is not None else None))
    return out


def test_under_the_profiler_every_span_is_a_range_of_the_same_name_and_nesting(fake_graphs):
    from torch.profiler import ProfilerActivity, profile

    cfg, engine = _tiny_engine()
    reqs = _requests(cfg, (4, 10), 2)
    ops = operands(5)
    ex = executor(ops)
    ex(*ops)  # captured before the session
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run(reqs)
        ex(*ops)
    obs.disable()
    with obs.span("after"):  # off: no range, no span
        pass
    rec = obs.record()
    seqs = {s.seq: s.name for s in rec.spans}
    want_ranges = [(s.name, seqs.get(s.parent)) for s in rec.spans]
    assert len(want_ranges) > 20
    assert _ranges(prof) == want_ranges


def test_no_range_outside_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    obs.enable()
    with obs.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("inside"):
            pass
    assert _ranges(prof) == [("inside", None)]
    assert [s.name for s in obs.record().spans] == ["before", "inside"]
