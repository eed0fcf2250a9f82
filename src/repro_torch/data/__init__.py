from .pipeline import (DataConfig, MemmapTokens, SyntheticLM, host_slice,
                       iterate, make_source)
