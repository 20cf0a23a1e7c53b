from repro_torch.data.sources import ArraySource, EpisodeSource
from repro_torch.data.loader import Prefetcher, ShardedLoader
from repro_torch.data.synthetic import (DistillationTask, FewShotSampler,
                                        LongTailDataset, TokenStream,
                                        make_logreg_problem)

__all__ = ['ArraySource', 'DistillationTask', 'EpisodeSource',
           'FewShotSampler', 'LongTailDataset', 'Prefetcher', 'ShardedLoader',
           'TokenStream', 'make_logreg_problem']
