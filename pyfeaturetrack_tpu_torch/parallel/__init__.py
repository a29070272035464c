"""Multi-GPU and multi-process paths on ``torch.distributed`` (port of
``pyfeaturetrack_tpu/parallel``): meshes and the sharded entries
(``sharding``), the cluster and the multi-process chunked sequence
(``multihost``), the weak-scaling sweep and the collective census
(``scaling``)."""

from .sharding import (make_mesh, track_batch_sharded,  # noqa: F401
                       shard_feature_state, multichip_track_step,
                       multichip_full_step, multichip_chunked_sequence,
                       multichip_batched_serving, dense_flow_sharded,
                       dense_disparity_sharded, split_mesh)
from .scaling import collective_census, measure_scaling  # noqa: F401
from .multihost import (initialize_cluster,  # noqa: F401
                        host_chunk_assignment, allgather_boundary_states,
                        track_sequence_multiprocess)
