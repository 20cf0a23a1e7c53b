from repro_torch.optim.optimizers import (AdamState, Optimizer, adam, chain,
                                          clip_by_global_norm, momentum, sgd)

__all__ = ['AdamState', 'Optimizer', 'adam', 'chain', 'clip_by_global_norm',
           'momentum', 'sgd']
