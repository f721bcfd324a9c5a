"""The parallel substrate on `torch.distributed`: partition rules and the
int8 error-feedback gradient sync (the port of `repro.parallel`)."""
from .sharding import ShardingPolicy, param_specs, batch_specs, to_named, activation_spec  # noqa: F401
from .collectives import compressed_psum_mean, compressed_grad_sync, init_error_state  # noqa: F401
