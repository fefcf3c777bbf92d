from recbox_tpu_torch.config.config import (
    Config, expand_tuner_space, hash_expid, load_config, parse_cli_overrides,
)

__all__ = ["Config", "load_config", "parse_cli_overrides", "hash_expid",
           "expand_tuner_space"]
