from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,  # noqa
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import lr_at  # noqa: F401
from repro_torch.optim.compress import (CompressionConfig,  # noqa
                                        compress_tree, decompress_tree)
