"""The port's feature-interaction layers against the JAX package's, on the
CPU.

Each layer of `recbox_tpu_torch/nn/interactions.py` gets the flax layer's
params (`interop.from_jax_params`) and the same numpy input; the forward
output and the gradients of a fixed random projection of it, with respect
to the input and to every parameter, are compared. Tolerances: f32 rtol
1e-5 on outputs, 1e-4 on gradients (atol 1e-6 / 1e-5 for entries that
cancel towards 0); under a bf16 input, 2e-2 (both sides promote to f32 at
the same places, so the rounding is the input's alone). The initial draws
are checked for their flax scale (xavier_normal at flax's fans for the
3-D kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from recbox_tpu.nn import interactions as J
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.nn import interactions as P

B, F_, D = 6, 5, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


# (name, JAX layer, port layer, input kind: 'field' (B, F, D) or 'flat')
CASES = [
    ("crossnet", lambda: J.CrossNet(2),
     lambda: P.CrossNet(F_ * D, 2, device="cpu"), "flat"),
    ("crossnet_v2", lambda: J.CrossNetV2(3),
     lambda: P.CrossNetV2(F_ * D, 3, device="cpu"), "flat"),
    ("crossnet_mix", lambda: J.CrossNetMix(2, low_rank=3, num_experts=2),
     lambda: P.CrossNetMix(F_ * D, 2, 3, 2, device="cpu"), "flat"),
    ("cin_identity", lambda: J.CompressedInteractionNet((3, 2)),
     lambda: P.CompressedInteractionNet(F_, (3, 2), device="cpu"), "field"),
    ("cin_relu", lambda: J.CompressedInteractionNet((3, 2), "relu"),
     lambda: P.CompressedInteractionNet(F_, (3, 2), "relu", device="cpu"),
     "field"),
    ("inner_product", lambda: J.InnerProduct(),
     lambda: P.InnerProduct(), "field"),
    ("senet", lambda: J.SENET(2),
     lambda: P.SENET(F_, 2, device="cpu"), "field"),
    ("bilinear_all", lambda: J.BilinearInteraction("field_all"),
     lambda: P.BilinearInteraction(F_, D, "field_all", device="cpu"),
     "field"),
    ("bilinear_each", lambda: J.BilinearInteraction("field_each"),
     lambda: P.BilinearInteraction(F_, D, "field_each", device="cpu"),
     "field"),
    ("bilinear_interaction",
     lambda: J.BilinearInteraction("field_interaction"),
     lambda: P.BilinearInteraction(F_, D, "field_interaction",
                                   device="cpu"), "field"),
    ("holographic_conv", lambda: J.HolographicInteraction(),
     lambda: P.HolographicInteraction(), "field"),
    ("holographic_corr",
     lambda: J.HolographicInteraction("circular_correlation"),
     lambda: P.HolographicInteraction("circular_correlation"), "field"),
    ("holographic_product",
     lambda: J.HolographicInteraction("elementwise_product"),
     lambda: P.HolographicInteraction("elementwise_product"), "field"),
    ("interaction_machine_2", lambda: J.InteractionMachine(2),
     lambda: P.InteractionMachine(D, 2, device="cpu"), "field"),
    ("interaction_machine_5", lambda: J.InteractionMachine(5),
     lambda: P.InteractionMachine(D, 5, device="cpu"), "field"),
    ("interacting_layer", lambda: J.InteractingLayer(3, 2),
     lambda: P.InteractingLayer(D, 3, 2, device="cpu"), "field"),
    ("interacting_layer_no_res", lambda: J.InteractingLayer(3, 2, False),
     lambda: P.InteractingLayer(D, 3, 2, False, device="cpu"), "field"),
]


def _input(kind, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, F_, D)).astype(
        np.float32)
    return x.reshape(B, -1) if kind == "flat" else x


@pytest.mark.parametrize("name,jlayer,player,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_forward_and_grads_match_jax(name, jlayer, player, kind):
    jm, pm = jlayer(), player()
    x = _input(kind)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), x))
    params = variables.get("params", {})
    if params:
        pm.load_state_dict(from_jax_params(params, pm))
    jout = np.asarray(jm.apply({"params": params}, x))
    w = np.random.default_rng(2).normal(size=jout.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    tx = torch.tensor(x, requires_grad=True)
    out = pm(tx)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-6)
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    if params:
        expect = from_jax_params(_np_tree(jgp), pm)
        named = dict(pm.named_parameters())
        assert set(expect) == set(named)
        for k, g in expect.items():
            np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["crossnet_v2", "cin_relu", "senet",
                                  "bilinear_interaction",
                                  "interacting_layer"])
def test_layer_promotes_bf16_input_as_flax(name):
    """A bf16 input: the layers with f32 parameters compute and return f32
    (flax promotes), within 2e-2 of JAX's."""
    _, jlayer, player, kind = next(c for c in CASES if c[0] == name)
    jm, pm = jlayer(), player()
    x = _input(kind, seed=3)
    params = _np_tree(jm.init(jax.random.PRNGKey(4), x))["params"]
    pm.load_state_dict(from_jax_params(params, pm))
    jout = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    out = pm(torch.from_numpy(x).to(torch.bfloat16))
    assert jout.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-2, atol=2e-2)


def test_inner_product_keeps_input_dtype_and_pair_order():
    x = torch.randn(2, 4, 3, dtype=torch.bfloat16)
    out = P.InnerProduct()(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 6)
    iu, ju = P.triu_pairs(4)
    jiu, jju = np.triu_indices(4, k=1)
    assert iu.tolist() == jiu.tolist() and ju.tolist() == jju.tolist()


def test_initial_draws_have_flax_scale():
    """xavier_normal at flax's fans: a (h, m, F) CIN kernel has fan_in m·h
    and fan_out F·h, a (E, d, r) expert kernel d·E and r·E; the layers
    that are a flax Dense draw lecun_normal (fan_in)."""
    g = torch.Generator().manual_seed(0)
    cin = P.CompressedInteractionNet(40, (64, 64), generator=g,
                                     device="cpu")
    w1 = cin.w1                                  # (64, 64, 40)
    want = np.sqrt(2.0 / (64 * 64 + 40 * 64))
    assert abs(float(w1.detach().std()) / want - 1) < 0.05
    mix = P.CrossNetMix(200, 1, 32, 4, generator=g, device="cpu")
    want = np.sqrt(2.0 / (200 * 4 + 32 * 4))
    assert abs(float(mix.U0.detach().std()) / want - 1) < 0.05
    att = P.InteractingLayer(256, 16, 2, generator=g, device="cpu")
    q_std = float(att.q.weight.detach().std())
    assert abs(q_std / np.sqrt(1 / 256) - 1) < 0.05
    cross = P.CrossNet(30, 1, generator=g, device="cpu")
    assert float(cross.b0.detach().abs().max()) == 0.0
