from repro_torch.optim.optimizers import (AdafactorState, AdamState,
                                          Optimizer, adafactor, adam, adamw,
                                          chain, clip_by_global_norm,
                                          cosine_schedule, momentum,
                                          scale_by_schedule, sgd,
                                          stacked_blocks,
                                          warmup_cosine_schedule)

__all__ = ['AdafactorState', 'AdamState', 'Optimizer', 'adafactor', 'adam',
           'adamw', 'chain', 'clip_by_global_norm', 'cosine_schedule',
           'momentum', 'scale_by_schedule', 'sgd', 'stacked_blocks',
           'warmup_cosine_schedule']
