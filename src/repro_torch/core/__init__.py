"""The paper's decoder in plain torch (port of ``repro.core``)."""
from .trellis import Trellis, make_trellis, STD_K7            # noqa: F401
from .encoder import encode                                    # noqa: F401
from .decoder import viterbi_decode, viterbi_forward, viterbi_traceback  # noqa: F401
from .framed import FrameSpec, framed_decode                   # noqa: F401
from .traceback import serial_traceback, parallel_traceback    # noqa: F401
from .puncture import puncture, depuncture, PATTERNS           # noqa: F401
from .pipeline import DecoderConfig, make_decoder, make_frame_decoder  # noqa: F401
from .sanitize import LLR_CLIP, sanitize_llr                   # noqa: F401
from .stream import (StreamContext, StreamDecoder,  # noqa: F401
                     make_stream_decoder, stream_decode)
