"""DogStatsD wire rendering (`render.py`) and the SSF framing
(`wire.py`)."""

from veneur_tpu_torch.protocol.wire import (  # noqa: F401
    MAX_SSF_PACKET_LENGTH,
    SSF_FRAME_LENGTH,
    FramingError,
    frame_ssf,
    InvalidTrace,
    SSFDecodeError,
    is_framing_error,
    parse_ssf,
    read_ssf,
    valid_trace,
    validate_trace,
    write_ssf,
)
