from .adamw import adamw, AdamW            # noqa: F401
from .schedule import warmup_cosine, constant  # noqa: F401
