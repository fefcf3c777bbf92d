from recbox_tpu_torch.nn.attention import (
    LayerNorm, PositionalEmbedding, TargetAttention, TransformerEncoder,
)
from recbox_tpu_torch.nn.core import (
    MLP, BatchNorm, Dice, Dropout, FactorizationMachine, LogisticRegression,
    get_activation, set_dropout_generator,
)
from recbox_tpu_torch.nn.embedding import (
    ROWS_PREFIX, FeatureEmbedding, concat_embeddings, masked_pool,
    rows_key_for, stack_embeddings,
)

__all__ = ["MLP", "BatchNorm", "Dice", "Dropout", "set_dropout_generator",
           "LayerNorm", "PositionalEmbedding", "TargetAttention",
           "TransformerEncoder",
           "FactorizationMachine", "LogisticRegression", "get_activation",
           "FeatureEmbedding", "concat_embeddings", "stack_embeddings",
           "masked_pool", "ROWS_PREFIX", "rows_key_for"]
