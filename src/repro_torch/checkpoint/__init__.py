from repro_torch.checkpoint.manager import (CheckpointManager, params_digest,
                                            restore, save)

__all__ = ['CheckpointManager', 'params_digest', 'save', 'restore']
