"""The host API (the ``KLT*`` facade, ``Tracker``, the sequence loop),
the device-resident sequence loop and its chained steps, and chunked
tracking."""
from .chunked import (  # noqa: F401
    chunk_bounds,
    stitch_chunk_tables,
    track_chunks_batched,
    track_sequence_chunked,
)
from .device_sequence import (  # noqa: F401
    select_step_device,
    sequence_chain_device,
    sequence_step_device,
    track_sequence_device,
)
from .sequence import (  # noqa: F401
    KeyframeTracker,
    SequenceTracker,
    frame_metrics,
    metrics_from_table,
    track_sequence,
)
from .tracker import (  # noqa: F401
    KLTChangeTCPyramid,
    KLTCountRemainingFeatures,
    KLTCreateFeatureList,
    KLTCreateFeatureTable,
    KLTCreateTrackingContext,
    KLTExtractFeatureList,
    KLTPrintTrackingContext,
    KLTReplaceLostFeatures,
    KLTSelectGoodFeatures,
    KLTStoreFeatureList,
    KLTTrackFeatures,
    KLTUpdateTCBorder,
    Tracker,
)
