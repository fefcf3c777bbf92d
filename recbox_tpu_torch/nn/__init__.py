from recbox_tpu_torch.nn.attention import (
    CapsuleNetwork, LayerNorm, MultiInterestSA, PositionalEmbedding,
    TargetAttention, TransformerEncoder,
)
from recbox_tpu_torch.nn.core import (
    MLP, BatchNorm, Dice, Dropout, FactorizationMachine, LogisticRegression,
    Reparam, get_activation, set_dropout_generator, set_reparam_generator,
)
from recbox_tpu_torch.nn.embedding import (
    ROWS_PREFIX, FeatureEmbedding, abstract_tables, concat_embeddings,
    emb_init, masked_pool, rows_key_for, stack_embeddings,
)
from recbox_tpu_torch.nn.interactions import (
    SENET, BilinearInteraction, CompressedInteractionNet, CrossNet,
    CrossNetMix, CrossNetV2, HolographicInteraction, InnerProduct,
    InteractingLayer, InteractionMachine,
)

__all__ = ["MLP", "BatchNorm", "Dice", "Dropout", "set_dropout_generator",
           "Reparam", "set_reparam_generator",
           "LayerNorm", "PositionalEmbedding", "TargetAttention",
           "TransformerEncoder", "CapsuleNetwork", "MultiInterestSA",
           "FactorizationMachine", "LogisticRegression", "get_activation",
           "FeatureEmbedding", "concat_embeddings", "stack_embeddings",
           "masked_pool", "emb_init", "abstract_tables", "ROWS_PREFIX",
           "rows_key_for", "CrossNet", "CrossNetV2", "CrossNetMix",
           "CompressedInteractionNet", "InnerProduct", "SENET",
           "BilinearInteraction", "HolographicInteraction",
           "InteractionMachine", "InteractingLayer"]
