from .pipeline import DataConfig, MemmapTokens, SyntheticLM, iterate, make_source
