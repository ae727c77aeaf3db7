"""Architecture registry: the archs the port runs, every arch of the
reference's registry (ROADMAP.md lists what is still to port beside
them)."""
from __future__ import annotations

import importlib
from repro_torch.models.config import ModelConfig

ARCHS = ["qwen2-1.5b", "paper-resnet", "paper-transformer",
         "codeqwen1.5-7b", "internlm2-20b", "mistral-large-123b",
         "moonshot-v1-16b-a3b", "dbrx-132b", "llava-next-34b",
         "seamless-m4t-large-v2", "recurrentgemma-9b", "xlstm-125m"]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def build_config(arch: str, *, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(
            f"arch {arch!r} is not in repro_torch's registry (have "
            f"{ARCHS}); ROADMAP.md lists the slices still to port")
    mod = _module(arch)
    cfg = mod.smoke() if smoke else mod.full()
    return cfg.replace(**overrides) if overrides else cfg
