"""Sequence drivers."""
from .device_sequence import (  # noqa: F401
    select_step_device,
    sequence_step_device,
    track_sequence_device,
)
