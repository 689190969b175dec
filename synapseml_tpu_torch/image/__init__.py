"""Image subsystem of the port: the torch op pipeline, the stages, IO and
the transfer-learning featurizer.

The counterpart of the reference package's ``image/`` (the reference's
opencv module, core image stages and ImageFeaturizer; SURVEY.md §2.4,
§2.6, §2.8).
"""
from synapseml_tpu_torch.image import ops  # noqa: F401
from synapseml_tpu_torch.image.featurizer import ImageFeaturizer  # noqa: F401
from synapseml_tpu_torch.image.reader import (  # noqa: F401
    decode_image,
    from_spark_layout,
    read_image_files,
    to_spark_layout,
)
from synapseml_tpu_torch.image.transformer import (  # noqa: F401
    ImageSetAugmenter,
    ImageTransformer,
    ResizeImageTransformer,
    UnrollBinaryImage,
    UnrollImage,
)
