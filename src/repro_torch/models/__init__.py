from .common import ModelConfig, check_supported
from .encdec import EncDec
from .registry import get_model
from .rwkv import RWKV
from .transformer import Transformer
