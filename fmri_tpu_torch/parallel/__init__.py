"""Training across ranks (``parallel/mesh.py``) and its dry run
(``parallel/dryrun.py``). The names are ``fmri_tpu.parallel``'s;
``batch_sharding``, ``replicated`` and ``shard_batch_multihost`` exist for
that parity alone."""

from fmri_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, batch_sharding, cognitive_param_specs,
    decoder_param_specs, initialize_multihost, make_mesh, replicated,
    shard_batch, shard_batch_multihost, shard_params, shard_state,
)
