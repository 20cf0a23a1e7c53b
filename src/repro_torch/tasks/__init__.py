from repro_torch.tasks.paper import (build_distillation, build_imaml,
                                     build_influence,
                                     build_logreg_weight_decay,
                                     build_reweighting, mlp_apply, mlp_init)

__all__ = ['build_distillation', 'build_imaml', 'build_influence',
           'build_logreg_weight_decay', 'build_reweighting', 'mlp_apply',
           'mlp_init']
