"""Architecture registry: --arch <id> -> (CONFIG, SMOKE_CONFIG).  Only the
architectures the port implements are listed, under the reference's
keys."""
from . import gemma2_9b, gpt2, qwen1_5_110b, stablelm_1_6b, yi_6b

ARCHS = {
    "qwen1.5-110b": qwen1_5_110b,
    "yi-6b": yi_6b,
    "gemma2-9b": gemma2_9b,
    "stablelm-1.6b": stablelm_1_6b,
    # paper's own family
    "gpt2-small": gpt2,
}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
