from recbox_tpu_torch.config.config import (
    Config, expand_tuner_space, hash_expid, load_config, parse_cli_overrides,
)
from recbox_tpu_torch.config.autotuner import (
    grid_search, grid_search_subprocess, save_tuner_configs,
)
from recbox_tpu_torch.config.hyper_tuning import HyperTuning

__all__ = ["Config", "load_config", "parse_cli_overrides", "hash_expid",
           "expand_tuner_space", "grid_search", "grid_search_subprocess",
           "save_tuner_configs", "HyperTuning"]
