from .pipeline import DataConfig, SyntheticLM, make_batch  # noqa: F401
