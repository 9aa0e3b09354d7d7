"""The launch plans and the layout rule of the port's row-reduction and
elementwise kernels (``conv.pool_plan``, ``ewise.ewise_plan``,
``ewise.walks_in_storage_order``), on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``), but
what decides how they are launched is plain Python: these tests hold it to
the kernels' constants and to the layouts the ResNet forward hands over.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, api, attention, conv, ewise, rglru_scan  # noqa: E402
from repro_torch.models import resnet  # noqa: E402



def ints(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-2**31, 2**31 - 1, shape).astype(np.int32))


def channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def test_plans_mirror_the_kernels_constants():
    for source, names in (("pool_reduce", {"THREADS": conv.POOL_THREADS}), ("ewise", {"THREADS": ewise.EWISE_THREADS}),
                          ("rglru_scan", {"SCAN_THREADS": rglru_scan.SCAN_THREADS, "SCAN_GROUP": rglru_scan.SCAN_GROUP,
                                          "SCAN_STEPS": rglru_scan.SCAN_STEPS, "SCAN_STAGES": rglru_scan.SCAN_STAGES}),
                          ("attention", {"KV_THREADS": attention.KV_THREADS})):
        text = (_build.CSRC / f"{source}.cu").read_text()
        for name, value in names.items():
            assert re.search(rf"constexpr int {name} = {value};", text), (source, name)


# K → lanes a row: one 16-byte vector a lane covers the row, up to a warp
@pytest.mark.parametrize("k, lanes", [(0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 2), (8, 2), (9, 4), (15, 4),
                                      (16, 4), (17, 8), (32, 8), (33, 16), (49, 16), (64, 16), (65, 32),
                                      (100, 32), (1000, 32), (65536, 32)])
def test_pool_plan_sizes_the_lane_group_to_k(k, lanes):
    got_lanes, vec, _ = conv.pool_plan(1000, k, 0)
    assert got_lanes == lanes and vec == (k % 4 == 0)


@pytest.mark.parametrize("ptr, k, vec", [(0, 4, True), (512, 16, True), (16, 100, True), (4, 4, False),
                                         (8, 16, False), (12, 1000, False), (0, 6, False), (0, 49, False)])
def test_pool_plan_takes_16_byte_loads_only_when_every_row_is_aligned(ptr, k, vec):
    assert conv.pool_plan(1000, k, ptr)[1] is vec


@pytest.mark.parametrize("rows, k, blocks", [
    (524288, 4, 2048),   # the stem's window matrix: a row a thread, 256 rows a block
    (16384, 16, 256),    # the global pool: 4 lanes a row, 64 rows a block
    (1, 4, 1), (1, 1000, 1), (1025, 4, 5), (1000, 100, 125), (2**31 - 1, 1, 2**23),
])
def test_pool_plan_gives_each_lane_group_one_row(rows, k, blocks):
    lanes, _, got = conv.pool_plan(rows, k, 0)
    assert got == blocks and got * (conv.POOL_THREADS // lanes) >= rows


@pytest.mark.parametrize("n, ptrs, plan", [
    (1000003, [0, 256, 512], (True, 1954)),   # 250000 vectors, one a thread, and one thread for the tail
    (1000000, [0, 256, 512], (True, 1954)),   # 250000 vectors, no tail
    (1000004, [0, 256, 512], (True, 1954)),   # 250001 vectors, no tail
    (32 * 64 * 32 * 32, [0, 0], (True, 4096)),  # the stem relu of RESNET18 at batch 32
    (3, [16, 32], (True, 1)),                 # the tail alone
    (5, [4, 4], (False, 1)),                  # not 16-byte aligned: the scalar kernel, one element a thread
    (5, [0, 4], (False, 1)),
    (1000, [0, 0, 8], (False, 8)),
])
def test_ewise_plan(n, ptrs, plan):
    assert ewise.ewise_plan(n, ptrs) == plan
    vec, blocks = plan
    assert blocks * ewise.EWISE_THREADS >= (n // 4 + (n % 4 > 0) if vec else n)


def _layouts():
    x = ints((2, 6, 5, 3), 1)
    xc = channels_last(x)
    return {
        "contiguous": ([x, ints((2, 6, 5, 3), 2)], True),
        "channels-last pair": ([xc, channels_last(ints((2, 6, 5, 3), 3))], True),
        "one channels-last operand": ([xc], True),
        "conv2d output view": ([api.conv2d(x, ints((4, 6, 3, 3), 4), padding=1)] * 2, True),
        "offset contiguous view": ([ints((31,), 5)[1:]], True),
        "mismatched strides": ([xc, x], False),
        "mismatched strides, contiguous first": ([x, xc], False),
        "expanded (stride 0)": ([torch.zeros(6, dtype=torch.int32).expand(4, 6)], False),
        "expanded second operand": ([x, x[:1].expand(2, 6, 5, 3)], False),
        "sliced non-dense view": ([ints((4, 8), 6)[:, 1:]], False),
        "transposed": ([ints((4, 8), 7).T], False),
    }


@pytest.mark.parametrize("case", sorted(_layouts()))
def test_walks_in_storage_order(case):
    operands, ok = _layouts()[case]
    assert ewise.walks_in_storage_order(operands) is ok


@pytest.mark.parametrize("case", sorted(c for c, (_, ok) in _layouts().items() if ok))
def test_storage_order_walk_gives_the_plain_result(case):
    """What the kernel computes on accepted operands: the op over each
    operand's storage in order, written into ``empty_like`` of the first,
    equals the plain version element for element."""
    operands, _ = _layouts()[case]
    out = torch.empty_like(operands[0])
    assert out.stride() == operands[0].stride()

    def flat(t):
        return torch.as_strided(t, (t.numel(),), (1,))

    want = ewise._ewise_plain("add", operands[0], operands[-1])
    flat(out).copy_(flat(operands[0]) + flat(operands[-1]))
    assert torch.equal(out, want)


def test_cpu_relu_and_add_keep_channels_last_strides():
    """The plain versions keep a channels-last input's layout, as the card's
    kernel does, so both devices hand the next layer one layout."""
    x, y = channels_last(ints((3, 8, 4, 4), 8)), channels_last(ints((3, 8, 4, 4), 9))
    for got in (api.relu(x), api.ewise_add(x, y)):
        assert got.stride() == x.stride() and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(api.ewise_add(x, y), x.contiguous() + y.contiguous())


NARROW_RESNET18 = dataclasses.replace(resnet.RESNET18, input_hw=16, stem_channels=8,
                                      stage_channels=(8, 8, 16, 16), num_classes=10)


@pytest.mark.parametrize("cfg, copied", [(NARROW_RESNET18, 0), (resnet.TINY, 1)], ids=["RESNET18-shaped", "TINY"])
def test_forward_hands_relu_and_add_operands_they_read_in_place(cfg, copied):
    """RESNET18's shape (no stem pool): every relu and add operand is a
    conv2d output, a relu output or a sum of them, all channels-last, so the
    card copies none.  TINY's stem max pool returns a contiguous tensor, so
    its first block's add (a channels-last conv output plus that identity)
    is copied."""
    params = resnet.init_params(cfg, device="cpu")
    x = resnet.make_input(cfg, 2, device="cpu")
    seen = []
    orig = ewise._ewise

    def rec(op, a, b=None):
        seen.append(ewise.walks_in_storage_order((a,) if b is None else (a, b)))
        return orig(op, a, b)

    ewise._ewise = rec
    try:
        resnet.forward(cfg, params, x)
    finally:
        ewise._ewise = orig
    names = resnet.layer_names(cfg)
    assert len(seen) == names.count("relu") + names.count("ewise_add") and seen.count(False) == copied
