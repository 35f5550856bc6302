"""Meshes, sharding rules and multi-process helpers: the port of
``vct/parallel``, with ``vct``'s public names."""

from vct_torch.parallel.mesh import (  # noqa: F401
    activate_mesh,
    ambient_mesh,
    batch_sharding,
    host_to_device,
    make_mesh,
    replicated,
    shard_batch,
)
from vct_torch.parallel.multihost import initialize, is_primary, process_shard  # noqa: F401
from vct_torch.parallel.shard import shard_params, shard_state_like_params  # noqa: F401
