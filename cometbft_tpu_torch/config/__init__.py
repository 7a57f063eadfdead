from cometbft_tpu_torch.config.config import (
    Config,
    default_config,
    test_config,
    load_config,
    write_config,
    dumps,
    loads,
)
