"""The Executor's replay rules (``repro_torch.kernels.program``) on the CPU.

On the card an Executor captures its program into a CUDA graph at its first
call and replays the graph afterwards; on the CPU it replays the ops
eagerly.  There are no CUDA graphs here, so the graph route is driven
through a fake of the ``_CudaGraph`` seam: its capture runs the ops once (as
a capture records them), its replay runs them again with their launch
counts withheld, as a real replay calls no Python.  ``api.dispatch`` is
wrapped to count a launch per op, as the kernel wrappers do on the card (on
the CPU they count nothing).  The card itself is covered by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import sys
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import bitslice_matmul as tbm  # noqa: E402
from repro_torch.kernels import program as tprogram  # noqa: E402


def ints(shape, lo, hi, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32))


def chain(xs, ws, y):
    return tapi.relu(tapi.ewise_add(tapi.matmul(xs, ws), y))


def operands(seed):
    """Sliced int16 × int8 operands (2 × 1 slice pairs) and an addend."""
    x, w, y = ints((8, 16), -3000, 3000, seed), ints((16, 8), -100, 100, seed + 1), ints((8, 8), -10**6, 10**6, seed + 2)
    return tapi.SlicedTensor.from_int(x, 16), tapi.SlicedTensor.from_int(w, 8), y


def want(xs, ws, y):
    return torch.clamp_min(xs.to_int() @ ws.to_int() + y, 0)


LAUNCHES = {"bitslice_matmul": 1, "ewise_add": 1, "relu": 1}


class FakeGraph:
    """Stands in for ``program._CudaGraph`` on the CPU."""

    capturing_now = False
    fail_with = None
    made = []

    @staticmethod
    def capturing():
        return FakeGraph.capturing_now

    def __init__(self, device):
        self.device, self.replays, self.was_reset = device, 0, False
        FakeGraph.made.append(self)

    def capture(self, fn):
        if FakeGraph.fail_with is not None:
            raise FakeGraph.fail_with
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def follow_last_call(self):
        pass

    def replay(self):
        self.replays += 1
        with tapi.recording_launches():  # a real replay runs no wrapper: nothing counts
            fresh = self.fn()
        for out, new in zip(self.outputs, fresh):
            out.copy_(new)

    def reset(self):
        self.was_reset = True


@pytest.fixture
def fake_graphs(monkeypatch):
    """CPU operands take the graph route through FakeGraph; every op
    dispatched outside a trace counts a launch, and the bit-sliced one sets
    the launch record its CUDA wrapper sets."""
    real = tapi.dispatch

    def counting(name, *args, **kwargs):
        out = real(name, *args, **kwargs)
        if tprogram.active_trace() is None:
            tapi.count_launch(name)
            if name == "bitslice_matmul":
                tbm._launched.pairs, tbm._launched.path = ("launched", kwargs["skip"]), "fake"
        return out

    monkeypatch.setattr(tprogram, "_GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(tprogram, "_CudaGraph", FakeGraph)
    monkeypatch.setattr(tapi, "dispatch", counting)
    monkeypatch.setattr(FakeGraph, "capturing_now", False)
    monkeypatch.setattr(FakeGraph, "fail_with", None)
    monkeypatch.setattr(FakeGraph, "made", [])
    tapi.clear_compile_cache()
    yield FakeGraph
    tapi.clear_compile_cache()


def executor(ops):
    return tapi.compile(tapi.trace(chain, name="replay_chain").program_for(*ops))


def test_cpu_executor_replays_eagerly_and_says_why():
    ops = operands(0)
    ex = executor(ops)
    assert (ex.replay, ex.replay_reason) == ("eager", "not called yet")
    tapi.reset_launch_counts()
    assert torch.equal(ex(*ops), want(*ops))
    assert tapi.launch_counts() == {}  # the plain versions launch nothing
    assert ex.replay == "eager" and "lie on the CPU" in ex.replay_reason
    assert ex._graphs == {}


def test_first_call_runs_eagerly_and_captures_without_counting_the_capture(fake_graphs):
    ops = operands(1)
    ex = executor(ops)
    tapi.reset_launch_counts()
    got = ex(*ops)
    assert torch.equal(got, want(*ops))
    assert tapi.launch_counts() == LAUNCHES  # the eager run's launches; the capture's went to its log
    assert (ex.replay, ex.replay_reason) == ("graph", tprogram.GRAPH_REASON)
    (graph,) = fake_graphs.made
    assert graph.replays == 0
    (replay,) = ex._graphs.values()
    assert replay.log.counts == LAUNCHES
    assert [tuple(i.shape) for i in replay.inputs] == [tuple(l.shape) for l in tprogram.tree_flatten((ops, {}))[0]]


def test_each_replay_adds_the_captured_counts_once_and_restores_the_pair_lists(fake_graphs):
    ops = operands(2)
    ex = executor(ops)
    ex(*ops)
    pairs, launched = tapi.last_executed_pairs(), tbm.launched_pairs()
    assert pairs == ((0, 0), (1, 0)) and launched == ("launched", ())
    # another bit-sliced matmul on this thread overwrites both records
    other = tapi.SlicedTensor.from_int(ints((4, 16), -3000, 3000, 9), 16)
    tapi.matmul(other, tapi.SlicedTensor.from_int(ints((16, 4), -30000, 30000, 10), 16), skip=((1, 1),))
    assert tapi.last_executed_pairs() != pairs and tbm.launched_pairs() != launched
    tapi.reset_launch_counts()
    for n in range(1, 4):
        got = ex(*ops)
        assert torch.equal(got, want(*ops))
        assert tapi.launch_counts() == {k: n * v for k, v in LAUNCHES.items()}
        assert tapi.last_executed_pairs() == pairs and tbm.launched_pairs() == launched
        assert tbm.launched_path() == "fake"
    assert fake_graphs.made[0].replays == 3 and ex.replay == "graph"


def test_replay_returns_fresh_tensors(fake_graphs):
    ops, other = operands(3), operands(4)
    ex = executor(ops)
    ex(*ops)
    second = ex(*ops)
    kept = second.clone()
    third = ex(*other)
    assert torch.equal(second, kept)  # the third call left the second call's output alone
    assert torch.equal(third, want(*other)) and not torch.equal(third, second)
    (replay,) = ex._graphs.values()
    buffers = {replay.outputs[0].data_ptr()}
    assert second.data_ptr() not in buffers and third.data_ptr() not in buffers


def test_traced_function_calls_replay_too(fake_graphs):
    traced = tapi.trace(chain, name="replay_chain")
    ops = operands(5)
    tapi.reset_launch_counts()
    first, second = traced(*ops), traced(*ops)
    assert torch.equal(first, want(*ops)) and torch.equal(second, want(*ops))
    assert tapi.launch_counts() == {k: 2 * v for k, v in LAUNCHES.items()}
    (graph,) = fake_graphs.made
    assert graph.replays == 1


def test_a_call_inside_a_capture_replays_eagerly_into_it(fake_graphs):
    ops = operands(6)
    ex = executor(ops)
    fake_graphs.capturing_now = True
    tapi.reset_launch_counts()
    assert torch.equal(ex(*ops), want(*ops))
    assert ex.replay == "eager" and "being captured" in ex.replay_reason
    assert tapi.launch_counts() == LAUNCHES and fake_graphs.made == [] and ex._graphs == {}
    fake_graphs.capturing_now = False
    ex(*ops)
    assert ex.replay == "graph" and len(fake_graphs.made) == 1


def test_a_failed_capture_keeps_eager_replay_with_its_reason_and_warns_once(fake_graphs):
    ops = operands(7)
    ex = executor(ops)
    fake_graphs.fail_with = RuntimeError("operation not permitted when stream is capturing")
    with pytest.warns(RuntimeWarning, match="operation not permitted when stream is capturing"):
        got = ex(*ops)
    assert torch.equal(got, want(*ops))
    assert ex.replay == "eager" and "operation not permitted when stream is capturing" in ex.replay_reason
    # the capture's launches went nowhere, and the records are the eager run's
    fake_graphs.fail_with = None
    tapi.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(ex(*ops), want(*ops))
    assert tapi.launch_counts() == LAUNCHES
    assert ex.replay == "eager" and "operation not permitted" in ex.replay_reason
    assert len(fake_graphs.made) == 1  # no second capture for this signature


def test_a_kernel_that_fails_to_launch_during_capture_raises(fake_graphs):
    ops = operands(8)
    ex = executor(ops)
    fake_graphs.fail_with = _build.KernelLaunchError("CUDA kernel relu failed to launch: error 1")
    with pytest.raises(_build.KernelLaunchError):
        ex(*ops)


def test_each_leaf_layout_gets_its_own_graph_with_that_layout(fake_graphs):
    a, b = ints((6, 10), -1000, 1000, 11), ints((6, 10), -1000, 1000, 12)
    ex = tapi.compile(tapi.trace(lambda u, v: tapi.ewise_add(u, v), name="add").program_for(a, b))
    at = a.t().contiguous().t()  # the same values, column-major
    assert torch.equal(ex(a, b), a + b) and torch.equal(ex(at, b), a + b)
    assert torch.equal(ex(at, b), a + b)
    assert len(ex._graphs) == 2 and [g.replays for g in fake_graphs.made] == [0, 1]
    strides = {key[1][0]: replay.inputs[0].stride() for key, replay in ex._graphs.items()}
    assert strides == {(10, 1): (10, 1), (1, 6): (1, 6)}


def test_clear_compile_cache_drops_the_graphs(fake_graphs):
    ops = operands(13)
    ex = executor(ops)
    ex(*ops)
    tapi.clear_compile_cache()
    assert fake_graphs.made[0].was_reset and ex._graphs == {}


def test_threads_sharing_an_executor_each_get_their_own_results(fake_graphs):
    sets = [operands(20 + 3 * i) for i in range(4)]
    wants = [want(*ops) for ops in sets]
    ex = executor(sets[0])
    ex(*sets[0])
    errors = []

    def worker(i):
        try:
            for _ in range(25):
                if not torch.equal(ex(*sets[i]), wants[i]):
                    errors.append(i)
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i % len(sets),)) for i in range(2 * len(sets))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert fake_graphs.made[0].replays == 25 * len(threads)


def test_recording_launches_diverts_counts_and_records_and_restores_them():
    tapi.reset_launch_counts()
    tapi.count_launch("relu")
    tapi.note_executed_pairs(((0, 0),))
    with tapi.recording_launches() as log:
        tapi.count_launch("relu")
        tapi.count_launch("gemm")
        tapi.note_executed_pairs(((1, 1),))
        assert tapi.launch_counts() == {"relu": 1}
        with pytest.raises(RuntimeError):
            with tapi.recording_launches():
                pass
    assert log.counts == {"relu": 1, "gemm": 1}
    assert tapi.launch_counts() == {"relu": 1} and tapi.last_executed_pairs() == ((0, 0),)
    tapi.replay_launches(log)
    assert tapi.launch_counts() == {"relu": 2, "gemm": 1} and tapi.last_executed_pairs() == ((1, 1),)
