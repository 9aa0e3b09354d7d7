"""The integer ResNet, plainly: every convolution an ``unfold`` and a matrix
product, every sum exact and then wrapped to int32 as a 32-bit accumulator
wraps.

The configuration states int32 arithmetic that wraps mod 2**32.  A product
of two int32 values and its sum over K terms is held exactly in ``acc``
(float64: each activation is below 2**31 in magnitude, each weight at most
``2**(weight_bits-1)``, K at most 4608, so every partial sum stays below
2**53) and then wrapped.  ``acc=torch.float32`` is the control: the same
network with its products summed in the next precision down, which cannot
hold them.

Parameters: ``{"stem": (OC, C, 3, 3), "stages": [[{"conv1", "conv2",
"proj"?}]], "head": (C, classes)}`` of int32 tensors; the input ``(N, C, H,
W)`` int32.  Nothing of the program is imported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_TWO32 = 2 ** 32
_TWO31 = 2 ** 31


def wrap(t: torch.Tensor) -> torch.Tensor:
    """Whole numbers (any dtype) to int32, mod 2**32."""
    if t.is_floating_point():
        t = torch.round(t)
    t = t.to(torch.int64)
    return (torch.remainder(t + _TWO31, _TWO32) - _TWO31).to(torch.int32)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int, acc: torch.dtype) -> torch.Tensor:
    n, _, h, _ = x.shape
    oc, _, kh, _ = w.shape
    cols = F.unfold(x.to(acc), (kh, kh), padding=pad, stride=stride)  # (N, C·KH·KW, L)
    out = w.reshape(oc, -1).to(acc) @ cols                              # (N, OC, L)
    ho = (h + 2 * pad - kh) // stride + 1
    return wrap(out).reshape(n, oc, ho, ho)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return wrap(x.to(torch.int64) + y.to(torch.int64))


def pool2(x: torch.Tensor, kind: str) -> torch.Tensor:
    """2 × 2 windows, stride 2: the max, or the wrapped sum floor-divided by 4."""
    n, c, h, w = x.shape
    win = x.reshape(n, c, h // 2, 2, w // 2, 2).to(torch.int64)
    if kind == "max":
        return win.amax(dim=(3, 5)).to(torch.int32)
    return torch.div(wrap(win.sum(dim=(3, 5))), 4, rounding_mode="floor").to(torch.int32)


def forward(cfg: dict, params: dict, x: torch.Tensor, acc: torch.dtype = torch.float64) -> torch.Tensor:
    """``(N, C, H, W)`` int32 → ``(N, classes)`` int32 logits."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the reference's products would round")
    h = relu(conv(x, params["stem"], 1, 1, acc))
    if cfg.get("stem_pool"):
        h = pool2(h, cfg["stem_pool"])
    for si, blocks in enumerate(params["stages"]):
        for bi, block in enumerate(blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            y = relu(conv(h, block["conv1"], stride, 1, acc))
            y = conv(y, block["conv2"], 1, 1, acc)
            identity = conv(h, block["proj"], stride, 0, acc) if "proj" in block else h
            h = relu(add(y, identity))
    n, c, hh, ww = h.shape
    s = wrap(h.reshape(n, c, hh * ww).to(torch.int64).sum(-1))
    h = torch.div(s, hh * ww, rounding_mode="floor").to(torch.int32)
    return wrap(h.to(acc) @ params["head"].to(acc))
