"""The port's initial state and state interchange against the JAX package.

``init_net`` draws from ``np.random.default_rng(seed)`` on the host in both
packages, so the states must be equal bit for bit; ``state_from_numpy`` /
``state_to_numpy`` must round-trip exactly.
"""

import jax
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.density import MODEL_TYPES
from rs_bann_tpu_torch.models import init as TI
from rs_bann_tpu_torch.models import params as TP

RAGGED = NetArch(m=(20, 13, 7), h=(8, 6, 8), s=(5, 4, 3), depth=1)


def _leaves(state):
    return jax.tree.leaves(tuple(state))


CFGS = {
    "default": {},
    "gamma_sampled_sparse": dict(init_gamma_shape=2.0, init_gamma_scale=0.5,
                                 sample_precisions=True, num_effective_markers=5),
    "variance_proportion": dict(init_param_variance=0.3, proportion_effective_markers=0.6),
}


@pytest.mark.parametrize("cfg_name", list(CFGS))
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_init_net_bit_identical_to_jax(model_type, cfg_name):
    kw = dict(CFGS[cfg_name], seed=7)
    j_state, j_mask = JI.init_net(RAGGED, model_type, JI.InitCfg(**kw))
    t_state, t_mask = TI.init_net(RAGGED, model_type, TI.InitCfg(**kw), device="cpu")
    jl = [np.asarray(a) for a in _leaves(j_state)]
    tl = _leaves(TP.state_to_numpy(t_state))
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert j.shape == t.shape and j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_fixed_precision_ard_refused_like_jax():
    cfg = dict(fixed_param_precision=1.0)
    with pytest.raises(NotImplementedError):
        JI.init_net(RAGGED, "ridge_ard", JI.InitCfg(**cfg))
    with pytest.raises(NotImplementedError):
        TI.init_net(RAGGED, "ridge_ard", TI.InitCfg(**cfg))


def test_state_numpy_round_trip():
    j_state, _ = JI.init_net(RAGGED, "lasso_ard", JI.InitCfg(seed=3))
    as_np = jax.tree.map(np.asarray, j_state)
    t_state = TP.state_from_numpy(as_np, "cpu")
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32 for a in _leaves(t_state))
    back = TP.state_to_numpy(t_state)
    for a, b in zip(_leaves(back), _leaves(as_np)):
        np.testing.assert_array_equal(a, b)
