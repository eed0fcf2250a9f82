"""Architecture registry: --arch <id> -> (CONFIG, SMOKE_CONFIG): every
architecture of the reference, under its keys."""
from . import (deepseek_moe_16b, gemma2_9b, gpt2,
               llama4_maverick_400b_a17b, qwen1_5_110b, qwen2_vl_7b,
               recurrentgemma_2b, rwkv6_7b, seamless_m4t_medium,
               stablelm_1_6b, yi_6b)
from .shapes import SHAPES, Cell, applicable, input_specs

ARCHS = {
    "qwen1.5-110b": qwen1_5_110b,
    "yi-6b": yi_6b,
    "gemma2-9b": gemma2_9b,
    "stablelm-1.6b": stablelm_1_6b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "rwkv6-7b": rwkv6_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "seamless-m4t-medium": seamless_m4t_medium,
    # paper's own family
    "gpt2-small": gpt2,
}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
