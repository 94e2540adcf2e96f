from repro_torch.sharding.specs import (cache_specs, param_specs,
                                        shard_shape, sharded_bytes)
