"""The port's copies of the JAX package's numpy/stdlib training modules
(``repro_torch/data/pipeline.py``, ``repro_torch/train/fault.py``) against
the originals: batches bit-equal at every (seed, step, rank, world), the
prefetching iterator's cursor, the heartbeat monitor, the elastic mesh
shapes and the restart policy equal on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402


def _both(cls_name, **kw):
    return getattr(jpipe, cls_name)(**kw), getattr(tpipe, cls_name)(**kw)


@pytest.mark.parametrize("seed,vocab,seq,batch,zipf_a,copy_frac", [
    (0, 256, 16, 4, 1.2, 0.3), (7, 256000, 64, 8, 1.2, 0.3), (3, 1000, 5, 2, 1.5, 0.0), (11, 32000, 128, 6, 1.1, 0.6),
])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_batches_bit_equal_to_jax(seed, vocab, seq, batch, zipf_a, copy_frac, rank, world):
    jc, tc = _both("DataConfig", vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed, zipf_a=zipf_a,
                   copy_frac=copy_frac)
    if batch % world:  # a global batch that does not split over the world: both assert
        for mod, c in ((jpipe, jc), (tpipe, tc)):
            with pytest.raises(AssertionError):
                mod.batch_at(c, 0, rank, world)
        return
    for step in (0, 1, 17, 10**6):
        want, got = jpipe.batch_at(jc, step, rank, world), tpipe.batch_at(tc, step, rank, world)
        assert sorted(want) == sorted(got) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32 and got[k].shape == (batch // world, seq)
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_iterator_and_cursor_equal_to_jax():
    """The prefetching iterator from a start step gives batch_at's batches
    in order, and ``state()`` is the next step to be consumed, as in JAX."""
    jc, tc = _both("DataConfig", vocab_size=500, seq_len=12, global_batch=4, seed=2)
    jp, tp = jpipe.TokenPipeline(jc, start_step=5), tpipe.TokenPipeline(tc, start_step=5, prefetch=3)
    try:
        assert jp.state() == tp.state() == 5
        for i in range(4):
            want, got = next(jp), next(tp)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(got[k], tpipe.batch_at(tc, 5 + i)[k])
            assert jp.state() == tp.state() == 6 + i
    finally:
        jp.close()
        tp.close()
    tp._thread.join(timeout=5)
    assert not tp._thread.is_alive()


def test_pipeline_resumes_from_a_cursor():
    """A pipeline started at a saved cursor continues the same stream."""
    tc = tpipe.DataConfig(vocab_size=300, seq_len=8, global_batch=2, seed=4)
    first = tpipe.TokenPipeline(tc)
    try:
        seen = [next(first) for _ in range(3)]
        cursor = first.state()
    finally:
        first.close()
    again = tpipe.TokenPipeline(tc, start_step=cursor)
    try:
        nxt = next(again)
    finally:
        again.close()
    assert cursor == 3
    np.testing.assert_array_equal(nxt["tokens"], tpipe.batch_at(tc, 3)["tokens"])
    assert not np.array_equal(nxt["tokens"], seen[-1]["tokens"])


def test_heartbeat_monitor_equal_to_jax():
    """The same beats (explicit clocks) give the same step times, dead
    workers, stragglers and alive counts."""
    jm, tm = jfault.HeartbeatMonitor(6, timeout_s=5.0, straggler_factor=1.5), \
        tfault.HeartbeatMonitor(6, timeout_s=5.0, straggler_factor=1.5)
    rng = np.random.default_rng(0)
    clock = {w: 0.0 for w in range(6)}
    for step in range(1, 12):
        for w in range(6):
            if w == 5 and step > 4:
                continue  # worker 5 stops beating
            clock[w] += float(rng.uniform(0.9, 1.1)) * (3.0 if w == 2 else 1.0)
            for m in (jm, tm):
                m.beat(w, step, now=clock[w])
    now = max(clock[w] for w in (0, 1, 3)) + 1.0
    for m in (jm, tm):
        m.mark_dead(4)
    assert tm.dead(now=now) == jm.dead(now=now) == [5]
    assert tm.stragglers() == jm.stragglers() == [2]
    assert tm.alive_count() == jm.alive_count() == 5
    assert tm._median_rate() == jm._median_rate()
    for w in range(6):
        a, b = jm.workers[w], tm.workers[w]
        assert (a.last_step, a.last_beat, list(a.step_times), a.alive) == \
            (b.last_step, b.last_beat, list(b.step_times), b.alive)


@pytest.mark.parametrize("survivors,model_axis,pod_axis", [
    (512, 16, 1), (510, 16, 1), (256, 16, 1), (16, 16, 1), (1024, 16, 2), (4096, 8, 4), (15, 16, 1), (31, 16, 2),
])
def test_elastic_mesh_shape_equal_to_jax(survivors, model_axis, pod_axis):
    try:
        want = jfault.elastic_mesh_shape(survivors, model_axis, pod_axis)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="not enough survivors"):
            tfault.elastic_mesh_shape(survivors, model_axis, pod_axis)
        assert "not enough survivors" in str(e)
        return
    assert tfault.elastic_mesh_shape(survivors, model_axis, pod_axis) == want


def test_restart_policy_equal_to_jax():
    jm, tm = jfault.HeartbeatMonitor(512), tfault.HeartbeatMonitor(512)
    jp, tp = jfault.RestartPolicy(max_restarts=2), tfault.RestartPolicy(max_restarts=2)
    for dead in ([17, 403], [0]):
        assert tp.on_failure(tm, dead) == jp.on_failure(jm, dead)
    assert tm.alive_count() == jm.alive_count() == 509
    for p, m in ((jp, jm), (tp, tm)):
        with pytest.raises(RuntimeError, match="restart budget exhausted"):
            p.on_failure(m, [1])
