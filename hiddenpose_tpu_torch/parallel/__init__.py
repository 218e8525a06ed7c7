from hiddenpose_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from hiddenpose_tpu_torch.parallel import distributed  # noqa: F401
