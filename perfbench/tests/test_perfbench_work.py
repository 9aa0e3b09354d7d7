"""The yardstick's formulas against hand counts at small shapes."""
import re

import pytest

import pbsetup
from perfbench.bench import spec
from perfbench.work import kernels, peaks, resnet as rw, transformer as tw


def test_conv_hand_count():
    c = rw.Conv(c_in=3, c_out=4, hw_in=6, k=3, stride=1, pad=1)
    assert c.hw_out == 6 and c.touched() == 6
    assert c.macs(2) == 2 * 36 * 4 * 27
    assert c.nbytes(2) == (2 * 3 * 36 + 4 * 27 + 2 * 4 * 36) * 4
    # int8 inputs and weights: a byte each; the int32 output four
    assert c.nbytes(2, 1, 1) == 2 * 3 * 36 + 4 * 27 + 2 * 4 * 36 * 4
    proj = rw.Conv(c_in=4, c_out=8, hw_in=6, k=1, stride=2, pad=0)
    assert proj.hw_out == 3 and proj.touched() == 3  # rows 0, 2, 4
    s2 = rw.Conv(c_in=4, c_out=8, hw_in=6, k=3, stride=2, pad=1)
    assert s2.hw_out == 3 and s2.touched() == 6


@pytest.mark.parametrize("bits,nbytes", [(8, 1), (3, 1), (4, 1), (9, 2), (16, 2), (32, 4)])
def test_value_bytes(bits, nbytes):
    assert rw.value_bytes(bits) == nbytes


def test_k1_least_time_of_a_one_conv_network():
    cfg = dict(in_channels=3, input_hw=6, stem_channels=4, stem_pool=None, stage_channels=[4],
               blocks_per_stage=[1], num_classes=5, input_bits=4, weight_bits=8)
    convs = rw.convs(cfg)
    assert [(c.c_in, c.c_out, c.k, c.stride) for c in convs] == [(3, 4, 3, 1), (4, 4, 3, 1), (4, 4, 3, 1)]
    b = 2

    def least(ops, nbytes):
        return max(ops / peaks.INT8_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)

    # by hand: every map 6 × 6; the stem reads its 4-bit input and every GEMM
    # its 8-bit weights at a byte a value, the rest int32
    want = least(2 * b * 36 * 4 * 27, b * 3 * 36 + 4 * 27 + b * 4 * 36 * 4)
    want += 2 * least(2 * b * 36 * 4 * 36, b * 4 * 36 * 4 + 4 * 36 + b * 4 * 36 * 4)
    want += least(2 * b * 4 * 5, (b * 4 + b * 5) * 4 + 4 * 5)
    assert rw.k1_least_s(cfg, b) == pytest.approx(want)
    # the bytes set every term at these sizes: 16-bit weights cost more
    assert rw.k1_least_s(dict(cfg, weight_bits=16), b) > rw.k1_least_s(cfg, b)


def test_resnet18_counts():
    cfg = spec.load_json(spec.PKG / "configs" / "resnet18-cifar-int8.json")
    convs = rw.convs(cfg)
    assert len(convs) + 1 == 21  # 21 GEMMs a forward (PERF.md §6 row 1)
    # hand count of one image: stem 1024·64·27, stage 0 4 × 1024·64·576, ...
    macs = 1024 * 64 * 27 + 4 * 1024 * 64 * 576
    macs += 256 * 128 * 576 + 3 * 256 * 128 * 1152 + 256 * 128 * 64
    macs += 64 * 256 * 1152 + 3 * 64 * 256 * 2304 + 64 * 256 * 128
    macs += 16 * 512 * 2304 + 3 * 16 * 512 * 4608 + 16 * 512 * 256
    assert rw.useful_ops(cfg, 1) == 2 * (macs + 512 * 10)
    # K1's least bytes of a b32 forward: the 11.2 M weights at a byte each, the
    # stem's int8 input, int32 activations; every conv and the head is bound
    # by its bytes at this size
    weights = sum(c.c_out * c.c_in * c.k ** 2 for c in convs) + 512 * 10
    assert weights == (64 * 3 * 9 + 4 * 64 * 64 * 9 + 128 * 64 * 9 + 3 * 128 * 128 * 9 + 128 * 64
                       + 256 * 128 * 9 + 3 * 256 * 256 * 9 + 256 * 128 + 512 * 256 * 9 + 3 * 512 * 512 * 9
                       + 512 * 256 + 512 * 10) == 11_164_352
    nbytes = 32 * 3 * 1024 + weights + 32 * 64 * 1024 * 4
    nbytes += sum(c.nbytes(32, 4, 0) for c in convs[1:]) + (32 * 512 + 32 * 10) * 4
    assert rw.k1_least_s(cfg, 32) == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)


def test_k4_hand_count():
    cfg = {"quant": {"act_bits": 8, "weight_bits": 8, "slice_bits": 8}}
    assert tw.live_pairs(cfg) == (1, 1, 1)
    assert tw.k4_call_least_s(cfg, 3, 16, 8) == max(2 * 3 * 8 * 16 / peaks.INT8_OPS_PER_S,
                                                    (48 + 128 + 96) / peaks.HBM_BYTES_PER_S)
    assert tw.live_pairs({"quant": {"act_bits": 16, "weight_bits": 8, "slice_bits": 8}}) == (2, 2, 1)
    assert tw.live_pairs({"quant": {"act_bits": 16, "weight_bits": 16, "slice_bits": 8}}) == (4, 2, 2)
    assert tw.live_pairs({"quant": {"act_bits": 32, "weight_bits": 32, "slice_bits": 8}})[0] == 10


def test_transformer_counts():
    cfg = spec.load_json(spec.PKG / "configs" / "minicpm-2b-int8.json")
    assert tw.layer_linears(cfg) == [(2304, 2304)] * 3 + [(2304, 2304), (2304, 5760), (2304, 5760), (5760, 2304)]
    assert tw.padded_vocab(cfg) == 122880
    macs = 4 * 2304 * 2304 + 3 * 2304 * 5760
    want = 2 * 40 * macs * 10 / peaks.INT8_OPS_PER_S
    want += (40 * 4 * 64 * 36 * 10 * 11 / 2 + 2 * 2304 * 122753) / peaks.BF16_FLOPS_PER_S
    assert tw.useful_least_s(cfg, [10]) == pytest.approx(want)
    t = tw.k4_least_s(cfg, 2, 100)
    assert t == pytest.approx(40 * sum(tw.k4_call_least_s(cfg, 200, k, n) for k, n in tw.layer_linears(cfg)))


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::tc::bitslice_mma_kernel<1, 1, 128, 32, 32>((anonymous namespace)::tc::Args)", "K4"),
    ("void (anonymous namespace)::bitslice_kernel<64, 64, 4>(signed char const*)", "K4"),
    ("void (anonymous namespace)::gemm_tile_kernel<true, 1>(unsigned int const*)", "K1"),
    ("gemm_small_kernel", "K1"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)", None),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<float>(int)", None),
    ("Memcpy HtoD (Pinned -> Device)", None),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_32x5_tn", None),
])
def test_kernel_names(name, kernel):
    assert kernels.kernel_of(name) == kernel


def test_every_kernel_of_the_port_is_listed():
    csrc = spec.ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    text = "".join(p.read_text() for p in csrc.glob("*.cu"))
    listed = {s for syms in kernels.symbols().values() for s in syms}
    defined = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", text))
    assert defined and defined <= listed
