from repro_torch.data.sources import ArraySource
from repro_torch.data.synthetic import LongTailDataset, make_logreg_problem

__all__ = ['ArraySource', 'LongTailDataset', 'make_logreg_problem']
