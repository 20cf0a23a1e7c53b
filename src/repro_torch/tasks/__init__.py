from repro_torch.tasks.paper import (build_logreg_weight_decay,
                                     build_reweighting, mlp_apply, mlp_init)

__all__ = ['build_logreg_weight_decay', 'build_reweighting', 'mlp_apply',
           'mlp_init']
