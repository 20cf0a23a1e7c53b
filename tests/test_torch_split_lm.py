"""``train_lm`` on a 2-rank mesh of gloo ranks against one rank's at the
same seeds: reduced Yi-9B, 4 inner steps with one outer step (k = 4,
ρ = 1e-2, ``column_chunk=2``), batch 4 × 16, over the CLI's host mesh
(2 × 1: the batch split over 'data') and over 1 × 2 (the model split over
'model'). The ranks' solver is ``flat_sharded`` over the blocks, one
rank's the CLI's default ('tree').

Tolerances: inner losses 1e-5 relative, the outer value 1e-5 and its
hypergradient 1e-4 relative L2, every final parameter block 1e-4. The LM
CLI run inside the 2-rank world (its host mesh) against the CLI in one
process: the same tolerances.
"""
import numpy as np
import pytest
import torch

import mesh_cases_split as cases
import split_reference as SR
import torch_mesh
from repro_torch.configs import get_config
from repro_torch.core import config_from_cli
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_lm
from torch_threads import torch_thread_cap  # noqa: F401

STEPS = 4
MESHES = {'host': (2, 1), 'model': (1, 2)}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('lm')
    tmp.mkdir(exist_ok=True)
    torch.save({'steps': STEPS}, tmp / 'inputs.pt')
    ranks, _ = torch_mesh.run_both('mesh_cases_split', 'lm', None, tmp, 2)
    return ranks


@pytest.fixture(scope='module')
def one():
    hg_cfg = config_from_cli('nystrom', flags={},
                             defaults={'k': cases.K, 'rho': cases.RHO},
                             column_chunk=cases.CHUNK)
    return train_lm(get_config(cases.ARCH).reduced(), hg_cfg, steps=STEPS,
                    batch=cases.B, seq=cases.S, outer_every=STEPS,
                    log_every=0, device='cpu')


@pytest.mark.parametrize('label', sorted(MESHES))
def test_losses_and_outer_step_match_one_rank(runs, one, label):
    for r in runs:
        got = r[label]
        assert len(got['losses']) == STEPS
        np.testing.assert_allclose(got['losses'], one.losses, rtol=1e-5)
        (val, hg), = got['outer']
        assert abs(val / one.outer[0]['val'] - 1) <= 1e-5
        assert SR.rel(hg.numpy(), one.outer[0]['hypergrad'].numpy()) <= 1e-4


@pytest.mark.parametrize('label', sorted(MESHES))
def test_final_parameters_are_one_ranks_blocks(runs, one, label):
    cfg = get_config(cases.ARCH).reduced()
    for r in runs:
        SR.assert_blocks_close(r[label]['params'], one.params, cfg,
                               MESHES[label], r[label]['coords'], 1e-4)


def test_cli_in_a_world_matches_one_process(runs):
    one = train_main(cases.cli_argv(STEPS))
    for r in runs:
        got = r['cli']
        np.testing.assert_allclose(got['losses'], one.losses, rtol=1e-5)
        (val, hg), = got['outer']
        assert abs(val / one.outer[0]['val'] - 1) <= 1e-5
        assert SR.rel(hg.numpy(), one.outer[0]['hypergrad'].numpy()) <= 1e-4
