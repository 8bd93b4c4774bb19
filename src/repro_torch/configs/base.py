"""Architecture + shape registry (port of ``src/repro/configs/base.py``).

Every ported architecture has a module exporting:
  config(shape: ShapeSpec|None, sparse=False) -> ModelConfig  (published)
  smoke_config() -> ModelConfig                 (reduced, CPU-runnable)
  extra_inputs(cfg, shape) -> dict[str, Tensor] (stub frontends; whisper
                                                and paligemma only)

Ported: every architecture of ``ARCH_NAMES``.  :func:`input_specs` and
the ``extra_inputs`` give ``meta`` tensors (shape and dtype, no storage),
PyTorch's ``ShapeDtypeStruct``, for the dry run (``launch/dryrun.py``).

Shapes (seq_len x global_batch):
  train_4k     4,096 x 256   training
  prefill_32k  32,768 x 32   inference
  decode_32k   32,768 x 128  inference (1 new token, KV cache of seq_len)
  long_500k    524,288 x 1   long-context; requires sub-quadratic
                             attention -> runs only for ssm / hybrid /
                             SWA archs
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

__all__ = ["ShapeSpec", "SHAPES", "ARCH_NAMES", "PORTED", "get_config",
           "get_smoke_config", "input_specs", "runnable", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_NAMES = [
    "qwen2_5_32b",
    "granite_3_2b",
    "phi3_medium_14b",
    "h2o_danube_1_8b",
    "whisper_small",
    "jamba_1_5_large_398b",
    "mamba2_780m",
    "deepseek_v2_236b",
    "deepseek_v3_671b",
    "paligemma_3b",
]

PORTED = ("granite_3_2b", "h2o_danube_1_8b", "phi3_medium_14b",
          "qwen2_5_32b", "deepseek_v2_236b", "deepseek_v3_671b",
          "mamba2_780m", "jamba_1_5_large_398b", "whisper_small",
          "paligemma_3b")

# archs with sub-quadratic sequence mixing -> long_500k runs
_LONG_OK = {"jamba_1_5_large_398b", "mamba2_780m", "h2o_danube_1_8b"}


def _module(arch: str):
    if arch not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, shape: str | ShapeSpec | None = None):
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    return _module(arch).config(spec)


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _LONG_OK
    return True


def skip_reason(arch: str, shape: str) -> str | None:
    if runnable(arch, shape):
        return None
    return (
        "long_500k requires sub-quadratic attention; "
        f"{arch} is a pure full-attention architecture (DESIGN §4)"
    )


def input_specs(arch: str, shape: str | ShapeSpec, cfg=None) -> dict:
    """``meta`` tensors standing in for every model input of the step the
    (arch, shape) cell builds: ``tokens`` (int32; ``[B, S + 1]`` to
    train, ``[B, S]`` to prefill, ``[B]`` to decode, with the 0-d
    ``pos``) and the architecture's ``extra_inputs``.  A VLM's ``S`` is
    the text's, ``seq_len - prefix_len``: the patch prefix takes the rest
    of the backbone's context."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg or get_config(arch, spec)
    mod = _module(arch)
    b, s = spec.global_batch, spec.seq_len
    s_text = s - (cfg.prefix_len or 0)

    def meta(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    out: dict = {}
    if spec.kind == "train":
        out["tokens"] = meta(b, s_text + 1)
    elif spec.kind == "prefill":
        out["tokens"] = meta(b, s_text)
    else:  # decode: one new token against a cache of seq_len
        out["tokens"] = meta(b)
        out["pos"] = meta()
    if hasattr(mod, "extra_inputs"):
        out.update(mod.extra_inputs(cfg, spec))
    return out
