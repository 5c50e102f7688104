"""Meshes, the multi-process bootstrap and the embedding engine (port of
vit_research_tpu/parallel/): the names the reference package exports."""

from vit_research_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    replicated,
)
from vit_research_tpu_torch.parallel.distributed import (  # noqa: F401
    all_gather_to_hosts,
    barrier,
    global_batch,
    initialize,
    pod_mesh,
    process_rows,
    shard_items,
)
