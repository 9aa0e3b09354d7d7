"""The port's mesh collectives (``repro_torch.dist.collectives``) against the
JAX package's on the same forced device count: every rank of a gloo process
group of n CPU processes calls the port's function with its shard, and its
result is held to the slice of JAX's ``shard_map`` output that device n
holds.  World sizes 2, 4 and 8 for all four; 3 and 6 also for the H-tree
all-reduce and the compressed mean (the ``psum`` branch).

Limits: the float32 butterfly, ``shuffle``, every int32 sum (they wrap) and
the compressed reduction's int8 payload and new error are bit-equal; the
``psum`` branch, the ring matmul and the compressed mean lie within 1e-6 of
the largest JAX value (another order of adds, and XLA's matmul).  JAX's own
checks of ``tests/test_dist.py`` (its multi-device script) hold for the
port's outputs at world 8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_ref import start_jax, start_ranks, to_np  # noqa: E402

WORLDS = (2, 3, 4, 6, 8)
POW2 = (2, 4, 8)
REL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for n in WORLDS:
        out[f"n{n}/htree_f32"] = rng.standard_normal((n * 3, 5)).astype(np.float32)
        out[f"n{n}/htree_arange"] = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
        out[f"n{n}/htree_i32"] = rng.integers(-2**31, 2**31, (n * 2, 4), dtype=np.int64).astype(np.int32)
        for tag in ("1", "2"):  # axes ("model",) and ("data", "model")
            out[f"n{n}/comp_g{tag}"] = rng.standard_normal(64).astype(np.float32)
            out[f"n{n}/comp_e{tag}"] = (0.01 * rng.standard_normal(64)).astype(np.float32)
        if n in POW2:
            out[f"n{n}/ring_a"] = rng.standard_normal((16, 8 * n)).astype(np.float32)
            out[f"n{n}/ring_w"] = rng.standard_normal((8 * n, 24)).astype(np.float32)
            out[f"n{n}/shuffle_i32_d0"] = np.arange(n * n * 3, dtype=np.int32).reshape(n * n, 3)
            out[f"n{n}/shuffle_f32_d1"] = rng.standard_normal((3, n * n * 2)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX's outputs, {n: each rank's results}); every group runs
    side by side under its own time limit."""
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    spec = {"inputs": str(tmp / "inputs.npz"), "worlds": list(WORLDS)}
    jax_run = start_jax("collectives", tmp, spec)
    ranks = {n: start_ranks("collectives", n, tmp, spec) for n in WORLDS}
    return inputs, jax_run.results(), {n: g.results() for n, g in ranks.items()}


def _shard(a, n, r, dim=0):
    c = a.shape[dim] // n
    return np.take(a, range(r * c, (r + 1) * c), axis=dim)


def _close(want, got, what):
    want = np.asarray(want)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= REL * float(np.abs(want).max()), f"{what}: max |diff| {err}"


@pytest.mark.parametrize("n", WORLDS)
def test_htree_allreduce_equals_jax(runs, n):
    _, want, ranks = runs
    for case in ("htree_f32", "htree_arange", "htree_i32"):
        key = f"n{n}/{case}"
        for r, res in enumerate(ranks[n]):
            got, exp = to_np(res[key]), _shard(want[key], n, r)
            assert got.dtype == exp.dtype and got.shape == exp.shape, key
            if n in POW2 or case == "htree_i32":  # the butterfly's order; int32 sums wrap, in any order
                assert np.array_equal(got, exp), (key, r)
            else:
                _close(exp, got, f"{key} rank {r}")


@pytest.mark.parametrize("n", POW2)
def test_ring_allgather_matmul_equals_jax(runs, n):
    _, want, ranks = runs
    for r, res in enumerate(ranks[n]):
        _close(want[f"n{n}/ring"], to_np(res[f"n{n}/ring"]), f"ring rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_compressed_psum_with_feedback_equals_jax(runs, n):
    _, want, ranks = runs
    for tag in ("1", "2"):
        for r, res in enumerate(ranks[n]):
            assert np.array_equal(to_np(res[f"n{n}/comp_q{tag}"]), want[f"n{n}/comp_q{tag}"]), (tag, r)
            assert np.array_equal(to_np(res[f"n{n}/comp_err{tag}"]), want[f"n{n}/comp_err{tag}"]), (tag, r)
            _close(want[f"n{n}/comp_red{tag}"], to_np(res[f"n{n}/comp_red{tag}"]), f"compressed {tag} rank {r}")


@pytest.mark.parametrize("n", POW2)
def test_shuffle_equals_jax(runs, n):
    _, want, ranks = runs
    for case, dim in (("shuffle_i32_d0", 0), ("shuffle_f32_d1", 1)):
        key = f"n{n}/{case}"
        for r, res in enumerate(ranks[n]):
            got = to_np(res[key])
            assert got.dtype == want[key].dtype and np.array_equal(got, _shard(want[key], n, r, dim)), (key, r)


def test_jax_multidevice_checks_hold_for_the_port(runs):
    """``tests/test_dist.py``'s checks of its 8-device script, on the port."""
    inputs, _, ranks = runs
    n = 8
    x = inputs["n8/htree_arange"]
    tree = np.concatenate([to_np(res["n8/htree_arange"]) for res in ranks[n]])
    assert np.allclose(tree, np.tile(x.reshape(8, 1, 4).sum(0), (8, 1)).reshape(8, 4)), "htree"
    a, w = inputs["n8/ring_a"], inputs["n8/ring_w"]
    for res in ranks[n]:
        assert np.allclose(to_np(res["n8/ring"]), a @ w, atol=1e-3), "ring matmul"
        g = inputs["n8/comp_g1"]
        red, new_err = to_np(res["n8/comp_red1"]), to_np(res["n8/comp_err1"])
        x_e = g + inputs["n8/comp_e1"]
        assert np.allclose(red, x_e, atol=0.05), "compressed psum"
        assert float(np.abs(new_err).max()) <= float(np.abs(x_e).max()) / 127 + 1e-6
    z = inputs["n8/shuffle_i32_d0"]
    sh = np.concatenate([to_np(res["n8/shuffle_i32_d0"]) for res in ranks[n]])
    assert np.array_equal(sh, z.reshape(8, 8, 1, 3).transpose(1, 0, 2, 3).reshape(8 * 8, 3)), "shuffle"
    xi = inputs["n8/htree_i32"]
    oi = to_np(ranks[n][0]["n8/htree_i32"])
    want_i = ((xi.astype(np.int64).reshape(8, 2, 4).sum(0) + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert np.array_equal(oi, want_i), "int32 htree"


@pytest.mark.parametrize("n", WORLDS)
def test_calls_go_through_gloo_in_the_schedule_of_each_collective(runs, n):
    """Every collective ran on the gloo group of the CPU mesh, in its
    schedule: the butterfly log2(n) exchanges a call (else one all_reduce),
    the ring n - 1 exchanges, the shuffle one all_to_all, the compressed
    mean one all_reduce an axis (the size-1 data axis has a group too)."""
    _, _, ranks = runs
    htree_calls, compressed_reduces = 3, 1 + 2
    for res in ranks[n]:
        assert res["backend"] == "gloo"
        if n in POW2:
            want = {"batch_isend_irecv": htree_calls * (n.bit_length() - 1) + (n - 1), "all_to_all_single": 2,
                    "all_reduce": compressed_reduces}
        else:
            want = {"all_reduce": htree_calls + compressed_reduces}
        assert res["calls"] == want, res["calls"]
