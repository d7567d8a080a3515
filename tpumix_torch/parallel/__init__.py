from tpumix_torch.parallel.distributed import (  # noqa: F401
    global_batch,
    initialize,
    process_count,
    process_index,
    shard_range,
)
from tpumix_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    data_parallel,
    make_mesh,
    replicated,
    shard_batch,
)
