"""synapseml_tpu_torch — the PyTorch/CUDA port of synapseml_tpu.

The JAX package ``synapseml_tpu`` beside this one is the reference; this
package imports nothing of it (nor JAX) and keeps its own copy of what it
needs. Its layout mirrors the reference, so each module's counterpart
has the same path:

  core/             param system + pipeline stages (own stage registry)
  data/             columnar Table data plane; partition streams into a
                    fit (partitions.py)
  gbdt/             GBDT scoring: Booster, LightGBM models, native format,
                    TreeSHAP, and the forest-traversal kernel (kernels.py,
                    csrc/forest_traverse.cu)
  isolationforest/  isolation forest (host fit, device scoring)
  parallel/         collectives over a torch.distributed process group
                    (data-parallel GBDT training), the driver rendezvous
                    and process-group bootstrap (distributed.py), the
                    launcher (launch.py)
  utils/            retry with backoff
  convert.py        carries a reference model's arrays into the port
  device.py         device policy: "cuda" by default, raise without CUDA

Hand-written CUDA kernels live in ``csrc/`` and are built at first use
into ``_build/`` (see ``_build.py``).
"""
__version__ = "0.1.0"

from synapseml_tpu_torch.core.param import ComplexParam, Param, Params
from synapseml_tpu_torch.core.pipeline import (
    Estimator, Evaluator, Model, Pipeline, PipelineModel, PipelineStage,
    Transformer,
)
from synapseml_tpu_torch.data.table import Table, concat_tables
