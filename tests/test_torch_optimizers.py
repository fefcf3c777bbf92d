"""The port's optimizers against optax through the JAX package's
`_make_optimizer`, on the CPU.

Each of adam, adamw (weight decay 1e-2), adagrad, sgd and rmsprop, with the
global-norm clip active (max norm 1 against gradients of norm ~20) and
without it, takes three steps on the same float32 parameters and
gradients (made with numpy), the learning rate lowered before the third
as plateau lowers it (`_set_learning_rate` / optax's injected
hyperparameter). Parameters agree to rtol 1e-6 after every step (atol
1e-9 for entries that pass near zero): the port computes the global norm
as the norm of the per-tensor norms, where optax sums every square at
once, and its sqrt / reciprocal where XLA takes rsqrt. The multi-tensor
Adam equals the per-tensor `_Adam` bit for bit on the CPU (the same ops in
the same order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.trainer import _make_optimizer as j_make
from recbox_tpu_torch.training.trainer import (
    TrainerConfig, _Adam, _ForeachAdam, _make_optimizer,
)

SHAPES = [(7, 5), (5,), (3, 4, 2), (1,)]
OPTIMIZERS = ["adam", "adamw", "adagrad", "sgd", "rmsprop"]


def _params(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _grads(seed, step):
    rng = np.random.default_rng(1000 * seed + step)
    return [(3.0 * rng.normal(size=s)).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, clip):
    kw = dict(optimizer=name, learning_rate=3e-2, grad_clip_norm=clip,
              weight_decay=1e-2 if name == "adamw" else 0.0)
    tx = j_make(JTrainerConfig(**kw))
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(_params(0))}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p) for p in _params(0)]
    opt = _make_optimizer(TrainerConfig(**kw), tparams)
    for step in range(3):
        if step == 2:       # plateau: lr x 0.1
            jstate.hyperparams["learning_rate"] = jnp.asarray(3e-3)
            opt.lr.fill_(3e-3)
        grads = _grads(0, step)
        if clip:
            assert np.sqrt(sum(np.sum(g ** 2) for g in grads)) > 10 * clip
        updates, jstate = tx.update(
            {str(i): jnp.asarray(g) for i, g in enumerate(grads)}, jstate,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        for i, p in enumerate(tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[str(i)]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name} step {step} p{i}")
    assert int(opt.count) == 3
    assert float(opt.lr) == np.float32(3e-3)


def test_optimizer_names_and_defaults():
    """optax's defaults, not torch.optim's: adagrad's accumulators start at
    0.1, rmsprop's at 0; adamw decays by the config's weight decay (0.0 by
    default, not optax's 1e-4); an unknown name raises."""
    p = [torch.ones(3)]
    opt = _make_optimizer(TrainerConfig(optimizer="adagrad"), p)
    assert torch.all(opt.state["sum_of_squares"][0] == 0.1)
    opt = _make_optimizer(TrainerConfig(optimizer="RMSProp"), p)
    assert torch.all(opt.state["nu"][0] == 0.0)
    opt = _make_optimizer(TrainerConfig(optimizer="adamw"), p)
    assert opt.weight_decay == 0.0
    assert _make_optimizer(TrainerConfig(grad_clip_norm=0.0), p).max_norm \
        is None
    with pytest.raises(NotImplementedError, match="optimizer=lamb"):
        _make_optimizer(TrainerConfig(optimizer="lamb"), p)


@pytest.mark.parametrize("clip", [1.0, None])
def test_foreach_adam_equals_per_tensor_adam(clip):
    a = [torch.from_numpy(p) for p in _params(1)]
    b = [t.clone() for t in a]
    fa, pa = _ForeachAdam(a, 3e-2, clip), _Adam(b, 3e-2, clip)
    for step in range(3):
        grads = [torch.from_numpy(g) for g in _grads(1, step)]
        fa.step(grads)
        pa.step(grads)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for name in ("mu", "nu"):
            for x, y in zip(fa.state[name], pa.state[name]):
                assert torch.equal(x, y)


def test_optimizer_state_round_trip():
    """`load_state_dict` copies in place (a captured step holds the
    tensors) and refuses a tensor of another shape."""
    p = [torch.from_numpy(x) for x in _params(2)]
    opt = _make_optimizer(TrainerConfig(), p)
    opt.step([torch.from_numpy(g) for g in _grads(2, 0)])
    saved = {k: (v.clone() if isinstance(v, torch.Tensor)
                 else [t.clone() for t in v])
             for k, v in opt.state_dict().items()}
    mu0 = opt.state["mu"][0]
    opt.step([torch.from_numpy(g) for g in _grads(2, 1)])
    opt.load_state_dict(saved)
    assert opt.state["mu"][0] is mu0 and torch.equal(mu0, saved["mu"][0])
    assert int(opt.count) == 1
    saved["nu"][1] = torch.zeros(2)
    with pytest.raises(ValueError, match="nu"):
        opt.load_state_dict(saved)
