from recbox_tpu_torch.features.schema import (
    CATEGORICAL, META, NUMERIC, SEQUENCE, FeatureMap, FeatureSpec,
)

__all__ = ["CATEGORICAL", "NUMERIC", "SEQUENCE", "META", "FeatureSpec",
           "FeatureMap"]
