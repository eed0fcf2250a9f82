from .decode import (generate, generate_lockstep, make_decode_burst,
                     make_serve_step, sample_tokens)
from .engine import Request, RequestResult, ServeEngine
from .prefix_cache import PrefixCache
