"""Scale-out on ``torch.distributed``: the ("data", "model") mesh, the
sharding rules and the collectives the JAX package leaves to GSPMD
(``parallel.mesh``: data, tensor and sequence parallelism), and GPipe
pipeline parallelism over the model axis (``parallel.pipeline``)."""

from lyricalignment_tpu_torch.parallel.mesh import (
    align_param_specs,
    batch_sharding,
    make_mesh,
    shard_align_params,
)
from lyricalignment_tpu_torch.parallel.pipeline import (
    make_pipeline_encode_fn,
    make_pipeline_logits_fn,
    pipeline_blocks,
    pipeline_decoder_blocks,
    pipeline_decoder_logits,
    pipeline_encode_audio,
    place_pipeline_params,
    stack_decoder_blocks,
    stack_encoder_blocks,
)

# the JAX package's __all__ (tests/test_torch_package_names.py holds them
# equal); the pipeline names above import from here all the same
__all__ = ["make_mesh", "batch_sharding", "shard_align_params", "align_param_specs"]
