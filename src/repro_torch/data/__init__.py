from repro_torch.data.sources import ArraySource
from repro_torch.data.synthetic import (DistillationTask, LongTailDataset,
                                        make_logreg_problem)

__all__ = ['ArraySource', 'DistillationTask', 'LongTailDataset',
           'make_logreg_problem']
