"""Architecture registry: one module per architecture (plain data; only the
dense and MoE families run in this port so far)."""

from importlib import import_module

ARCH_IDS = [
    "paligemma_3b", "grok_1_314b", "dbrx_132b", "zamba2_2p7b", "mamba2_1p3b",
    "whisper_large_v3", "stablelm_12b", "qwen1p5_4b", "qwen3_0p6b",
    "llama3p2_3b", "paper_mlp",
]

_ALIASES = {
    "paligemma-3b": "paligemma_3b", "grok-1-314b": "grok_1_314b",
    "dbrx-132b": "dbrx_132b", "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-1.3b": "mamba2_1p3b", "whisper-large-v3": "whisper_large_v3",
    "stablelm-12b": "stablelm_12b", "qwen1.5-4b": "qwen1p5_4b",
    "qwen3-0.6b": "qwen3_0p6b", "llama3.2-3b": "llama3p2_3b",
    "paper-mlp": "paper_mlp",
}


def get_config(arch: str):
    mod = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    return import_module(f"repro_torch.configs.{mod}").CONFIG


def all_arch_names():
    return [a for a in _ALIASES if a != "paper-mlp"]
