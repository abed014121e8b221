"""Model configs of the port: the paper's own models and the dense
assigned architectures (yi-6b, qwen2.5-14b, llama3.2-1b, gemma3-4b), all
four published in bfloat16.

``get_config(name)`` -> full config; ``get_smoke_config(name)`` -> the
reduced same-family config for CPU tests.  The MoE, SSM, VLM and
encoder-decoder architectures of the JAX package are later slices.
"""
import importlib

PAPER_IDS = ["h1d-lm-53m", "h1d-lm-144m", "h1d-lra-encoder"]
ARCH_IDS = ["yi-6b", "qwen2.5-14b", "llama3.2-1b", "gemma3-4b"]

_MODULES = {**{name: "h1d_lm" for name in PAPER_IDS},
            "yi-6b": "yi_6b", "qwen2.5-14b": "qwen2_5_14b",
            "llama3.2-1b": "llama3_2_1b", "gemma3-4b": "gemma3_4b"}


def _module(name: str):
    if name not in _MODULES:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; available: "
            f"{PAPER_IDS + ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIGS[name]()


def get_smoke_config(name: str):
    return _module(name).SMOKES[name]()
