"""Shared by the benchmark's tests: the import paths of a checkout, and the
cells' configurations and traffic cut to sizes a CPU test run holds."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.bench import spec  # noqa: E402


def tiny_resnet(**kw) -> dict:
    """``resnet18-cifar-int8`` with two one-block stages at 8 × 8 (and a max-pooled stem)."""
    cfg = dict(spec.load_json(spec.PKG / "configs" / "resnet18-cifar-int8.json"), stage_channels=[8, 16],
               blocks_per_stage=[1, 1], input_hw=8, stem_channels=8, stem_pool="max", num_classes=10)
    cfg.update(kw)
    return cfg


def tiny_transformer(**kw) -> dict:
    """``minicpm-2b-int8`` at two layers of width 64, GQA 4/2, vocabulary 256."""
    cfg = dict(spec.load_json(spec.PKG / "configs" / "minicpm-2b-int8.json"), hidden_size=64,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               intermediate_size=128, vocab_size=256)
    cfg.update(kw)
    return cfg


def tiny_images(**kw) -> dict:
    tr = dict(spec.load_json(spec.PKG / "traffic" / "images-b32.json"), batch=4, pool_batches=3,
              check_batches=4, trace_batches=3)
    tr.update(kw)
    return tr


def tiny_prompts(**kw) -> dict:
    tr = dict(spec.load_json(spec.PKG / "traffic" / "prefill-512.json"), batch=4, min_len=8, max_len=24,
              pool_requests=64, cache_len=32, check_batches=3, check_rows=2, trace_batches=2)
    tr.update(kw)
    return tr
