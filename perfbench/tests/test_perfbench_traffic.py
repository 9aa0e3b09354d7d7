"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same sizes; any whole number is a seed."""
import numpy as np
import pytest
import torch

import pbsetup
from perfbench.bench import traffic as tr

SEEDS = [0, 7, 2**31 - 1, 2**31 + 5, 2**40 + 3, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_prompts_repeat_for_a_seed(seed):
    t = pbsetup.tiny_prompts()
    a, b = tr.prompt_pool(t, 256, seed), tr.prompt_pool(t, 256, seed)
    assert len(a) == t["pool_requests"] and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.dtype == np.int32 and x.min() >= 0 and x.max() < 256 for x in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_images_repeat_for_a_seed(seed):
    cfg, t = pbsetup.tiny_resnet(), pbsetup.tiny_images()
    a, b = tr.image_pool(t, cfg, seed, pin=False), tr.image_pool(t, cfg, seed, pin=False)
    assert torch.equal(a, b) and a.dtype == torch.int32
    lim = 2 ** (cfg["input_bits"] - 1) - 1  # the signed input_bits range, symmetric
    assert a.shape == (t["pool_batches"], t["batch"], 3, 8, 8) and int(a.abs().max()) <= lim


def test_other_seeds_other_inputs_same_sizes():
    t, cfg, ti = pbsetup.tiny_prompts(), pbsetup.tiny_resnet(), pbsetup.tiny_images()
    pools = [tr.prompt_pool(t, 256, s) for s in SEEDS]
    for i, p in enumerate(pools):
        for q in pools[i + 1:]:
            assert [len(x) for x in p] != [len(x) for x in q]
            assert sorted(len(x) for x in p) == sorted(len(x) for x in q)
    images = [tr.image_pool(ti, cfg, s, pin=False) for s in SEEDS]
    assert all(not torch.equal(a, b) for i, a in enumerate(images) for b in images[i + 1:])


def test_lengths_spread_evenly():
    t = dict(pbsetup.tiny_prompts(), min_len=128, max_len=512, pool_requests=4096)
    lengths = tr.prompt_lengths(t)
    assert lengths.min() == 128 and lengths.max() == 512
    counts = np.bincount(lengths - 128)
    assert counts.min() >= 10 and counts.max() <= 11  # 4096 over 385 lengths


def test_substreams_differ():
    for seed in SEEDS:
        s = tr.substreams(seed)
        assert len(set(s)) == len(s)
    assert tr.substreams(1) != tr.substreams(-1)


@pytest.mark.parametrize("seed", SEEDS)
def test_stratified_batches_take_one_length_from_each_stratum(seed):
    t = dict(pbsetup.tiny_prompts(), min_len=100, max_len=499, pool_requests=400, batch=4)
    pool = tr.prompt_pool(t, 256, seed)
    edges = np.sort(tr.prompt_lengths(t)).reshape(4, -1)
    for j in range(0, len(pool), 4):
        got = sorted(len(p) for p in pool[j:j + 4])
        assert all(lo <= g <= hi for g, lo, hi in zip(got, edges[:, 0], edges[:, -1]))
    assert sorted(len(p) for p in pool) == sorted(tr.prompt_lengths(t))
