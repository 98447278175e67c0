"""Distribution on ``torch.distributed`` (port of ``vl_merging_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS, FSDP_AXIS, Mesh, make_mesh, batch_sharding, replicated,
    param_shardings, shard_params, shard_batch, global_put,
    initialize, initialize_multihost, cluster_spec_from_env,
)
from .host import (  # noqa: F401
    get_rank, get_world_size, is_main_process, synchronize,
    all_gather_objects, reduce_dict, fetch_global, process_rows,
    all_gather_with_grad,
)
