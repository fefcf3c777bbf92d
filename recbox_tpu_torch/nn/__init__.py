from recbox_tpu_torch.nn.core import (
    MLP, FactorizationMachine, LogisticRegression, get_activation,
)
from recbox_tpu_torch.nn.embedding import (
    ROWS_PREFIX, FeatureEmbedding, concat_embeddings, masked_pool,
    rows_key_for, stack_embeddings,
)

__all__ = ["MLP", "FactorizationMachine", "LogisticRegression",
           "get_activation", "FeatureEmbedding", "concat_embeddings",
           "stack_embeddings", "masked_pool", "ROWS_PREFIX", "rows_key_for"]
