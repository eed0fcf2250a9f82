from .common import ModelConfig, check_supported
from .registry import get_model
from .transformer import Transformer
