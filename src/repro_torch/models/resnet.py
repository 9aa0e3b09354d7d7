"""ResNet18-style integer CNN built entirely from registry kernels (PyTorch
port of the JAX package's ``models/resnet.py``).

The network runs in the raw integer domain end to end: int8-range inputs and
weights, int32 accumulation that wraps mod 2**32, integer pooling that
floor-divides.  At ``RESNET18`` width the conv outputs reach the 32-bit cap
by the second conv, so the logits depend on the wrap: every GEMM, add and
pool sum of the port wraps exactly as the JAX oracle does.

:func:`init_params` and :func:`make_input` draw from ``np.random.default_rng``
in the same order as the JAX package, so both packages build identical
integers from a seed.  :func:`params_from_numpy` takes the JAX package's
parameter tree (as numpy arrays) instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import api

Params = Dict[str, Any]


@dataclass(frozen=True)
class ResNetConfig:
    """A parameterizable BasicBlock ResNet (ResNet18 shape at ``RESNET18``).

    ``stage_channels[i]`` / ``blocks_per_stage[i]`` describe stage i; every
    stage after the first downsamples spatially by 2 (stride-2 first conv +
    1×1 projection shortcut).
    """

    in_channels: int = 3
    input_hw: int = 32
    stem_channels: int = 8
    stem_pool: Optional[str] = "max"  # "max" | "avg" | None (2×2, stride 2)
    stage_channels: Tuple[int, ...] = (8, 16)
    blocks_per_stage: Tuple[int, ...] = (2, 2)
    num_classes: int = 10
    input_bits: int = 4   # operand magnitude bound of the quantized input
    weight_bits: int = 3  # weights drawn from the signed weight_bits range

    def __post_init__(self):
        if len(self.stage_channels) != len(self.blocks_per_stage):
            raise ValueError("stage_channels and blocks_per_stage differ in length")

    @property
    def final_hw(self) -> int:
        hw = self.input_hw
        if self.stem_pool:
            hw //= 2
        return hw // (2 ** (len(self.stage_channels) - 1))


# One 8×8 image through a stem, a stem pool, two stages (one BasicBlock
# each, the second downsampling), global pool over 2×2 and a 10-class head.
TINY = ResNetConfig(
    in_channels=3, input_hw=8, stem_channels=8, stem_pool="max",
    stage_channels=(8, 16), blocks_per_stage=(1, 1), num_classes=10,
)

# The paper-shaped evaluation config (ResNet18 topology at CIFAR scale):
# 4 stages × 2 BasicBlocks, 1000 classes.
RESNET18 = ResNetConfig(
    in_channels=3, input_hw=32, stem_channels=64, stem_pool=None,
    stage_channels=(64, 128, 256, 512), blocks_per_stage=(2, 2, 2, 2),
    num_classes=1000,
)


def _winit(rng: np.random.Generator, shape: Tuple[int, ...], bits: int) -> np.ndarray:
    """Weights uniform over the signed ``bits`` range."""
    lim = 2 ** (bits - 1)
    return rng.integers(-lim + 1, lim, shape)


def _numpy_params(cfg: ResNetConfig, seed: int) -> Params:
    rng = np.random.default_rng(seed)
    wb = cfg.weight_bits
    params: Params = {
        "stem": _winit(rng, (cfg.stem_channels, cfg.in_channels, 3, 3), wb),
        "stages": [],
    }
    c_in = cfg.stem_channels
    for si, (c_out, n_blocks) in enumerate(zip(cfg.stage_channels, cfg.blocks_per_stage)):
        blocks: List[Params] = []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            block: Params = {
                "conv1": _winit(rng, (c_out, c_in, 3, 3), wb),
                "conv2": _winit(rng, (c_out, c_out, 3, 3), wb),
            }
            if stride != 1 or c_in != c_out:
                block["proj"] = _winit(rng, (c_out, c_in, 1, 1), wb)
            blocks.append(block)
            c_in = c_out
        params["stages"].append(blocks)
    params["head"] = _winit(rng, (c_in, cfg.num_classes), wb)
    return params


def params_from_numpy(tree: Params, device: Any = "cuda") -> Params:
    """The port's parameters from a tree ``{"stem", "stages": [[{conv1,
    conv2, proj?}]], "head"}`` of arrays (the JAX package's layout): int32
    tensors on ``device``."""
    dev = api.resolve_device(device)

    def leaf(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=dev)

    return {
        "stem": leaf(tree["stem"]),
        "stages": [[{k: leaf(v) for k, v in block.items()} for block in blocks]
                   for blocks in tree["stages"]],
        "head": leaf(tree["head"]),
    }


def init_params(cfg: ResNetConfig, seed: int = 0, *, device: Any = "cuda") -> Params:
    """Deterministic integer parameters for ``cfg`` (int32 tensors holding
    ``weight_bits``-range values), equal to the JAX package's for one seed."""
    return params_from_numpy(_numpy_params(cfg, seed), device)


def make_input(cfg: ResNetConfig, batch: int = 1, seed: int = 1, *, device: Any = "cuda") -> torch.Tensor:
    """A quantized input image batch within the config's ``input_bits`` range."""
    dev = api.resolve_device(device)
    rng = np.random.default_rng(seed)
    lim = 2 ** (cfg.input_bits - 1)
    x = rng.integers(-lim + 1, lim, (batch, cfg.in_channels, cfg.input_hw, cfg.input_hw))
    return torch.as_tensor(x.astype(np.int32), device=dev)


def _conv_out_bits(bits_in: int, bits_w: int, k: int) -> int:
    """Static worst-case precision of a K-term integer conv/matmul output,
    capped at 32 (where the accumulator's wraparound == int32)."""
    return min(bits_in + bits_w + math.ceil(math.log2(max(k, 2))), 32)


def forward(cfg: ResNetConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The forward pass: ``(B, C, H, W) int32 → (B, num_classes) int32``, on
    the device of ``x`` and ``params``.  The static bit bounds are passed to
    each kernel as hints, as in the JAX package."""
    wb = cfg.weight_bits
    bits = cfg.input_bits

    h = api.conv2d(x, params["stem"], stride=1, padding=1, x_bits=bits, w_bits=wb)
    bits = _conv_out_bits(bits, wb, cfg.in_channels * 9)
    h = api.relu(h)
    if cfg.stem_pool == "max":
        h = api.maxpool2d(h, window=2)
    elif cfg.stem_pool == "avg":
        h = api.avgpool2d(h, window=2)
        bits = max(2, min(bits + 2, 32) - 2)

    c_in = cfg.stem_channels
    for si, blocks in enumerate(params["stages"]):
        c_out = cfg.stage_channels[si]
        for bi, block in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            identity, id_bits = h, bits
            y = api.conv2d(h, block["conv1"], stride=stride, padding=1,
                           x_bits=bits, w_bits=wb)
            b1 = _conv_out_bits(bits, wb, c_in * 9)
            y = api.relu(y)
            y = api.conv2d(y, block["conv2"], stride=1, padding=1,
                           x_bits=b1, w_bits=wb)
            b2 = _conv_out_bits(b1, wb, c_out * 9)
            if "proj" in block:
                identity = api.conv2d(h, block["proj"], stride=stride, padding=0,
                                      x_bits=bits, w_bits=wb)
                id_bits = _conv_out_bits(bits, wb, c_in)
            h = api.relu(api.ewise_add(y, identity))
            bits = min(max(b2, id_bits) + 1, 32)
            c_in = c_out

    h = api.global_avgpool(h)
    gap_k = cfg.final_hw * cfg.final_hw
    shift = int(math.log2(max(gap_k, 1)))
    bits = max(2, min(bits + shift, 32) - shift)
    return api.int_matmul(h, params["head"], x_bits=bits, w_bits=wb)


def layer_names(cfg: ResNetConfig) -> List[str]:
    """The kernel sequence :func:`forward` emits, in call order."""
    names = ["conv2d", "relu"]
    if cfg.stem_pool == "max":
        names.append("maxpool2d")
    elif cfg.stem_pool == "avg":
        names.append("avgpool2d")
    c_in = cfg.stem_channels
    for si, n_blocks in enumerate(cfg.blocks_per_stage):
        c_out = cfg.stage_channels[si]
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            names += ["conv2d", "relu", "conv2d"]
            if stride != 1 or c_in != c_out:
                names.append("conv2d")  # projection shortcut
            names += ["ewise_add", "relu"]
            c_in = c_out
    names += ["global_avgpool", "int_matmul"]
    return names


class ResNet(nn.Module):
    """:func:`forward` as a module holding the int32 weights as buffers
    (``stem``, ``s{stage}_b{block}_{conv1|conv2|proj}``, ``head``).

    ``params`` defaults to :func:`init_params` of ``seed``; the module lives
    on ``device`` (``"cuda"`` unless the caller asks for the CPU).
    """

    def __init__(self, cfg: ResNetConfig, params: Optional[Params] = None, *,
                 seed: int = 0, device: Any = "cuda"):
        super().__init__()
        dev = api.resolve_device(device)
        self.cfg = cfg
        params = init_params(cfg, seed, device=dev) if params is None else params
        self.register_buffer("stem", params["stem"].to(dev))
        self._blocks = []
        for si, blocks in enumerate(params["stages"]):
            for bi, block in enumerate(blocks):
                for key, w in block.items():
                    self.register_buffer(f"s{si}_b{bi}_{key}", w.to(dev))
                self._blocks.append((si, bi, tuple(block)))
        self.register_buffer("head", params["head"].to(dev))

    def params(self) -> Params:
        """The parameter tree :func:`forward` takes, over this module's buffers."""
        stages: List[List[Params]] = []
        for si, bi, keys in self._blocks:
            if bi == 0:
                stages.append([])
            stages[si].append({k: getattr(self, f"s{si}_b{bi}_{k}") for k in keys})
        return {"stem": self.stem, "stages": stages, "head": self.head}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params(), x)
