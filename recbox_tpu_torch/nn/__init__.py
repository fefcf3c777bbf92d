from recbox_tpu_torch.nn.attention import (
    LayerNorm, PositionalEmbedding, TransformerEncoder,
)
from recbox_tpu_torch.nn.core import (
    MLP, BatchNorm, Dropout, FactorizationMachine, LogisticRegression, get_activation,
    set_dropout_generator,
)
from recbox_tpu_torch.nn.embedding import (
    ROWS_PREFIX, FeatureEmbedding, concat_embeddings, masked_pool,
    rows_key_for, stack_embeddings,
)

__all__ = ["MLP", "BatchNorm", "Dropout", "set_dropout_generator", "LayerNorm",
           "PositionalEmbedding", "TransformerEncoder",
           "FactorizationMachine", "LogisticRegression", "get_activation",
           "FeatureEmbedding", "concat_embeddings", "stack_embeddings",
           "masked_pool", "ROWS_PREFIX", "rows_key_for"]
