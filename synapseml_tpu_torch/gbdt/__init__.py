from synapseml_tpu_torch.gbdt.boosting import BoostParams, Booster, train
from synapseml_tpu_torch.gbdt.estimators import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMDelegate,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)

__all__ = [
    "BoostParams", "Booster", "LightGBMClassificationModel",
    "LightGBMClassifier", "LightGBMDelegate", "LightGBMRanker",
    "LightGBMRankerModel", "LightGBMRegressionModel", "LightGBMRegressor",
    "train",
]
