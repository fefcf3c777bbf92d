from recbox_tpu_torch.nn.core import MLP, get_activation
from recbox_tpu_torch.nn.embedding import (
    FeatureEmbedding, concat_embeddings, masked_pool,
)

__all__ = ["MLP", "get_activation", "FeatureEmbedding", "concat_embeddings",
           "masked_pool"]
