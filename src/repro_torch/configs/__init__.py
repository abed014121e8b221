"""Model configs of the port: the paper's own models and the ten
assigned architectures, all published in bfloat16: the dense ones
(yi-6b, qwen2.5-14b, llama3.2-1b, gemma3-4b), the encoder-decoder
(seamless-m4t-medium), the MoE ones (qwen2-moe-a2.7b, arctic-480b), the
VLM backbone (llava-next-34b), the SSM (mamba2-1.3b) and the hybrid
(zamba2-1.2b).

``get_config(name)`` -> full config; ``get_smoke_config(name)`` -> the
reduced same-family config for CPU tests; ``SHAPES`` the per-arch input
shapes of the dry run and the roofline (``launch/``).
"""
import importlib

PAPER_IDS = ["h1d-lm-53m", "h1d-lm-144m", "h1d-lra-encoder"]
ARCH_IDS = ["yi-6b", "qwen2.5-14b", "llama3.2-1b", "gemma3-4b",
            "seamless-m4t-medium", "qwen2-moe-a2.7b", "arctic-480b",
            "llava-next-34b", "mamba2-1.3b", "zamba2-1.2b"]

_MODULES = {**{name: "h1d_lm" for name in PAPER_IDS},
            "yi-6b": "yi_6b", "qwen2.5-14b": "qwen2_5_14b",
            "llama3.2-1b": "llama3_2_1b", "gemma3-4b": "gemma3_4b",
            "seamless-m4t-medium": "seamless_m4t_medium",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "arctic-480b": "arctic_480b",
            "llava-next-34b": "llava_next_34b",
            "mamba2-1.3b": "mamba2_1_3b", "zamba2-1.2b": "zamba2_1_2b"}

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


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
