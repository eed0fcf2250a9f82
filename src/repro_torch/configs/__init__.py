"""Architecture registry: --arch <id> -> (CONFIG, SMOKE_CONFIG).  Only the
architectures the port implements are listed."""
from . import gpt2, stablelm_1_6b

ARCHS = {
    "stablelm-1.6b": stablelm_1_6b,
    # paper's own family
    "gpt2-small": gpt2,
}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
