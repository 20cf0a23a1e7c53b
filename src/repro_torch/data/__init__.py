from repro_torch.data.sources import ArraySource, EpisodeSource
from repro_torch.data.synthetic import (DistillationTask, FewShotSampler,
                                        LongTailDataset, make_logreg_problem)

__all__ = ['ArraySource', 'DistillationTask', 'EpisodeSource',
           'FewShotSampler', 'LongTailDataset', 'make_logreg_problem']
