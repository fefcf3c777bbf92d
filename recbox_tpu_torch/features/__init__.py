from recbox_tpu_torch.features.schema import (
    CATEGORICAL, META, NUMERIC, SEQUENCE, FeatureMap, FeatureSpec,
    auto_embedding_dim,
)
from recbox_tpu_torch.features.tokenizer import (
    Normalizer, Tokenizer, pad_sequences,
)
from recbox_tpu_torch.features.encoder import FeatureEncoder

__all__ = [
    "FeatureMap", "FeatureSpec", "Tokenizer", "Normalizer", "FeatureEncoder",
    "pad_sequences", "auto_embedding_dim", "CATEGORICAL", "NUMERIC",
    "SEQUENCE", "META",
]
