from tacorl_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    replicate,
    shard_params_by_rule,
    sync_metrics,
)
