"""Work of the integer ResNet, from its configuration's shapes alone.

K1 (the port's integer GEMM) runs every convolution (after ``im2col``) and
the head.  Its least time for a convolution is the larger of

* its operations, 2 · M · N · K (M = batch · OH · OW, N = output channels,
  K = C · KH · KW), at the card's fastest integer rate, the int8 tensor
  cores, and
* its bytes, each once: the input elements that some window reads, the
  weights and the output.  A weight takes the bytes its ``weight_bits``
  need (one for int8) and the stem's input those its ``input_bits`` need;
  every later activation and every output is int32, since the sums wrap
  mod 2**32 and reach the full 32 bits,

so the share stays at or under 1 whatever implements the convolution
(an explicit ``im2col`` and GEMM, or an implicit GEMM, on operands packed
as narrow as their values allow).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from perfbench.work import peaks

ITEMSIZE = 4  # int32 activations after the stem, and every output


def value_bytes(bits: int) -> int:
    """Bytes that hold a signed ``bits``-bit value: a whole byte at least."""
    return -(-bits // 8)


@dataclass(frozen=True)
class Conv:
    c_in: int
    c_out: int
    hw_in: int
    k: int
    stride: int
    pad: int

    @property
    def hw_out(self) -> int:
        return (self.hw_in + 2 * self.pad - self.k) // self.stride + 1

    def touched(self) -> int:
        """Input rows (and columns) that some window reads."""
        rows = {o * self.stride + i - self.pad for o in range(self.hw_out) for i in range(self.k)}
        return sum(1 for r in rows if 0 <= r < self.hw_in)

    def macs(self, batch: int) -> int:
        return batch * self.hw_out ** 2 * self.c_out * self.c_in * self.k ** 2

    def nbytes(self, batch: int, in_bytes: int = ITEMSIZE, w_bytes: int = ITEMSIZE) -> int:
        inp = batch * self.c_in * self.touched() ** 2 * in_bytes
        weights = self.c_out * self.c_in * self.k ** 2 * w_bytes
        return inp + weights + batch * self.c_out * self.hw_out ** 2 * ITEMSIZE


def convs(cfg: dict) -> List[Conv]:
    """Every convolution of one forward, in call order: the stem, then each
    BasicBlock's conv1, conv2 and (where the shape changes) its 1×1
    projection."""
    hw = cfg["input_hw"]
    out = [Conv(cfg["in_channels"], cfg["stem_channels"], hw, 3, 1, 1)]
    if cfg.get("stem_pool"):
        hw //= 2
    c_in = cfg["stem_channels"]
    for si, (c_out, n) in enumerate(zip(cfg["stage_channels"], cfg["blocks_per_stage"])):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            c1 = Conv(c_in, c_out, hw, 3, stride, 1)
            out += [c1, Conv(c_out, c_out, c1.hw_out, 3, 1, 1)]
            if stride != 1 or c_in != c_out:
                out.append(Conv(c_in, c_out, hw, 1, stride, 0))
            hw, c_in = c1.hw_out, c_out
    return out


def head(cfg: dict) -> Tuple[int, int]:
    """(K, N) of the head's GEMM."""
    return cfg["stage_channels"][-1], cfg["num_classes"]


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / peaks.INT8_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)


def k1_least_s(cfg: dict, batch: int) -> float:
    """K1's least time for one forward of ``batch`` images: the stem reads
    ``input_bits`` inputs, every GEMM ``weight_bits`` weights."""
    wb = value_bytes(cfg["weight_bits"])
    k, n = head(cfg)
    t = least_s(2 * batch * k * n, (batch * k + batch * n) * ITEMSIZE + k * n * wb)
    stem, *rest = convs(cfg)
    t += least_s(2 * stem.macs(batch), stem.nbytes(batch, value_bytes(cfg["input_bits"]), wb))
    return t + sum(least_s(2 * c.macs(batch), c.nbytes(batch, ITEMSIZE, wb)) for c in rest)


def useful_ops(cfg: dict, batch: int) -> int:
    """2 · the multiply-adds of every convolution and the head."""
    k, n = head(cfg)
    return 2 * (sum(c.macs(batch) for c in convs(cfg)) + batch * k * n)


def useful_least_s(cfg: dict, batch: int) -> float:
    """The forward's useful operations at the int8 peak."""
    return useful_ops(cfg, batch) / peaks.INT8_OPS_PER_S
