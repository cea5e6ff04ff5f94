from .step import (make_train_step, make_accum_train_step,
                   make_prefill_step, make_decode_step)   # noqa: F401
from .loop import LoopConfig, train_loop                   # noqa: F401
from . import checkpoint                                   # noqa: F401
