from .decode import generate, make_decode_burst, sample_tokens
from .engine import Request, RequestResult, ServeEngine
