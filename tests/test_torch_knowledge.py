"""The knowledge stage of the port against the JAX package, on the CPU.

- `data.knowledge`: `build_neighbor_table`, `build_ripple_sets`,
  `collaborative_kg_edges`, ``KnowledgeGraph.with_inverse`` and
  `AtomicDataset.to_knowledge_graph` equal JAX's arrays bit for bit; a
  relation id 0, triples of unequal length and an out-of-range user raise
  ValueError.
- CKE, CFKG, KTUP, MKR, KGCN (each aggregator, two hops), KGNNLS, KGAT,
  RippleNet, KGIN, MCCLK and KSR on JAX's initial params (moved by
  `interop.from_jax_params`, every parameter filled; MKR's KG head
  initialised apart, as JAX's pipeline does): the training scores of a
  batch, the towers, the pairwise loss's gradients and ``kg_loss`` with
  its gradients (rtol 1e-5 / 1e-4, or 1e-4 of the model's largest
  gradient entry), KGNNLS's label propagation, KGIN's independence loss,
  MCCLK's contrastive loss, KSR's user tower and scores. KGAT's attention
  is computed per relation in the port and per edge in JAX.

Each model's initial draw, and the AttributeError of a model built
without its graph arrays, are in `test_torch_kg_pipeline.py`.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.data import knowledge as JK
from recbox_tpu.data.atomic import load_atomic_dataset as jload
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models import knowledge as J
from recbox_tpu.models.knowledge import intent as JI
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu_torch.data import knowledge as PK
from recbox_tpu_torch.data.atomic import load_atomic_dataset as pload
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import knowledge as P
from recbox_tpu_torch.ops.losses import get_matching_loss

RTOL, GTOL, ATOL = 1e-5, 1e-4, 1e-7
N_USERS, N_ITEMS, N_CATS, DIM, B, L = 20, 30, 5, 8, 12, 5
N_ENT = N_ITEMS + N_CATS + 4      # items, categories, a few plain entities
N_REL = 3                         # interact (0), has_cat (1), linked (2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _world(seed=0):
    """A KG (items → their category, some items → a plain entity) and
    interactions."""
    rng = np.random.default_rng(seed)
    items = np.arange(N_ITEMS)
    extra = rng.choice(N_ITEMS, 12, replace=False)
    heads = np.concatenate([items, extra]).astype(np.int64)
    rels = np.concatenate([np.full(N_ITEMS, 1), np.full(12, 2)])
    tails = np.concatenate([N_ITEMS + items % N_CATS,
                            N_ITEMS + N_CATS + rng.integers(0, 4, 12)])
    kw = dict(heads=heads, relations=rels.astype(np.int64),
              tails=tails.astype(np.int64), n_entities=N_ENT,
              n_relations=N_REL, n_items=N_ITEMS)
    users = rng.integers(0, N_USERS, 150)
    inter_items = rng.integers(0, N_ITEMS, 150)
    return JK.KnowledgeGraph(**kw), PK.KnowledgeGraph(**kw), users, \
        inter_items


def _u2i(users, items):
    out = {}
    for u, i in zip(users, items):
        out.setdefault(int(u), []).append(int(i))
    return out


def test_neighbor_table_matches_jax():
    jkg, pkg, _, _ = _world()
    for k, seed in ((4, 0), (2, 3)):
        for a, b in zip(JK.build_neighbor_table(jkg, k, seed),
                        PK.build_neighbor_table(pkg, k, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ripple_sets_match_jax():
    jkg, pkg, users, items = _world()
    u2i = _u2i(users, items)
    u2i[N_USERS + 1] = [N_ENT + 5]              # no KG-reachable seed
    for hops, mem, seed in ((2, 6, 0), (3, 4, 2)):
        want = JK.build_ripple_sets(jkg, u2i, hops, mem, seed)
        got = PK.build_ripple_sets(pkg, u2i, hops, mem, seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_collaborative_kg_edges_and_inverse_match_jax():
    jkg, pkg, users, items = _world()
    for a, b in zip(JK.collaborative_kg_edges(jkg, users, items, N_USERS),
                    PK.collaborative_kg_edges(pkg, users, items, N_USERS)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    ji, pi = jkg.with_inverse(), pkg.with_inverse()
    for f in ("heads", "relations", "tails", "n_entities", "n_relations",
              "n_items"):
        np.testing.assert_array_equal(getattr(pi, f), getattr(ji, f))
    assert pi.n_triples == ji.n_triples
    with pytest.raises(ValueError, match="num_users"):
        PK.collaborative_kg_edges(pkg, users, items, 3)
    with pytest.raises(ValueError, match="start at 1"):
        PK.KnowledgeGraph(np.array([0]), np.array([0]), np.array([1]),
                          2, 1, 1)
    with pytest.raises(ValueError, match="length"):
        PK.KnowledgeGraph(np.array([0, 1]), np.array([1]), np.array([1]),
                          2, 2, 1)


def test_to_knowledge_graph_matches_jax(tmp_path):
    d = tmp_path / "kgs"
    d.mkdir()
    (d / "kgs.inter").write_text(
        "user_id:token\titem_id:token\trating:float\n"
        "u1\ti1\t5\nu1\ti2\t3\nu2\ti3\t4\nu3\ti1\t2\n")
    (d / "kgs.link").write_text(
        "item_id:token\tentity_id:token\ni1\te1\ni2\te2\ni4\te4\n")
    (d / "kgs.kg").write_text(
        "head_id:token\trelation_id:token\ttail_id:token\n"
        "e1\tby\te9\ne2\tby\te9\ne4\tin\te7\ne9\tin\te7\n")
    jds, pds = jload(str(d), "kgs"), pload(str(d), "kgs")
    for filt in (None, dict(min_rating=3.0)):
        if filt:
            jds, pds = (jds.filter_interactions(**filt),
                        pds.filter_interactions(**filt))
        jkg, pkg = jds.to_knowledge_graph(), pds.to_knowledge_graph()
        for f in ("heads", "relations", "tails"):
            np.testing.assert_array_equal(getattr(pkg, f), getattr(jkg, f))
        assert (pkg.n_entities, pkg.n_relations, pkg.n_items) == \
            (jkg.n_entities, jkg.n_relations, jkg.n_items)
    os.remove(d / "kgs.kg")
    with pytest.raises(ValueError, match="no .kg"):
        pload(str(d), "kgs").to_knowledge_graph()


# -- the models -----------------------------------------------------------

def _maps():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    return (JFeatureMap("kg", tuple(JFeatureSpec(n, "categorical", s,
                                                 vocab_size=v,
                                                 embedding_dim=DIM)
                                    for n, s, v in specs), **kw),
            FeatureMap("kg", tuple(FeatureSpec(n, "categorical", s,
                                               vocab_size=v,
                                               embedding_dim=DIM)
                                   for n, s, v in specs), **kw))


def _graph_kwargs(name, jkg, users, items, static):
    """The model's graph arrays (wrapped in JAX's `StaticArray` when
    ``static``)."""
    wrap = J.StaticArray if static else (lambda a: a)
    if name in ("KGCN", "KGNNLS"):
        ents, rels = JK.build_neighbor_table(jkg, 3, 0)
        return dict(neighbor_entities=wrap(ents),
                    neighbor_relations=wrap(rels), n_hops=2)
    if name == "KGAT":
        h, r, t = JK.collaborative_kg_edges(jkg, users, items, N_USERS)
        return dict(ckg_heads=wrap(h), ckg_relations=wrap(r),
                    ckg_tails=wrap(t), n_layers=2, kg_dim=4)
    if name in ("KGIN", "MCCLK"):
        return dict(inter_users=wrap(users.astype(np.int32)),
                    inter_items=wrap(items.astype(np.int32)),
                    kg_heads=wrap(jkg.heads.astype(np.int32)),
                    kg_relations=wrap(jkg.relations.astype(np.int32)),
                    kg_tails=wrap(jkg.tails.astype(np.int32)))
    if name == "KSR":
        ents, _ = JK.build_neighbor_table(jkg, 2, 1)
        return dict(kg_neighbors=wrap(ents))
    return {}


MODELS = {
    "CKE": dict(num_items=N_ITEMS, kg_dim=4),
    "CFKG": {},
    "KTUP": dict(num_items=N_ITEMS, n_preferences=3),
    "MKR": dict(num_items=N_ITEMS, n_layers_cc=2, user_hidden=(6,)),
    "KGCN": dict(num_items=N_ITEMS),
    "KGNNLS": dict(num_items=N_ITEMS, aggregator="concat"),
    "KGAT": {},
    "RippleNet": dict(num_items=N_ITEMS, n_hops=2),
    "KGIN": dict(n_intents=3),
    "MCCLK": dict(ssl_tau=0.3),
    "KSR": dict(hidden_size=6, dropout=0.0),
}


def _batches(name, jkg, users, items, seed=4):
    rng = np.random.default_rng(seed)
    b = {"user_id": rng.integers(0, N_USERS, B).astype(np.int32)}
    ids = rng.integers(0, N_ITEMS, (B, 4)).astype(np.int32)
    b["__item_ids__"] = ids
    b["item::item_id"] = ids
    if name == "RippleNet":
        rs = JK.build_ripple_sets(jkg, _u2i(users, items), 2, 4, 0)
        row = {int(u): k for k, u in enumerate(rs["users"])}
        sel = np.array([row.get(int(u), 0) for u in b["user_id"]])
        for k in ("heads", "relations", "tails"):
            b[f"ripple_{k}"] = rs[k][sel]
    if name == "KSR":
        seq = rng.integers(1, N_ITEMS, (B, L)).astype(np.int32)
        lens = rng.integers(1, L + 1, B).astype(np.int32)
        seq[np.arange(L)[None, :] < (L - lens)[:, None]] = 0   # left-padded
        b = {"item_seq": seq, "seq_len": lens, "item_id": ids[:, 0]}
    kb = {"kg_head": rng.integers(0, N_ENT, 16).astype(np.int32),
          "kg_relation": rng.integers(1, N_REL, 16).astype(np.int32),
          "kg_tail": rng.integers(0, N_ENT, 16).astype(np.int32),
          "kg_neg_tail": rng.integers(0, N_ENT, 16).astype(np.int32)}
    if name == "RippleNet":
        kb = {k: v for k, v in b.items() if k.startswith("ripple_")}
    if name == "KGAT":
        kb["kg_head"] = rng.integers(0, N_ENT + N_USERS, 16).astype(np.int32)
    return b, kb


def _build(name, jfm, pfm, kw, static_kw, port_kw, seed, generator=None):
    jm = getattr(J, name, None) or getattr(JI, name)
    jm = jm(feature_map=jfm, embedding_dim=DIM, **kw, **static_kw)
    pm = getattr(P, name)(pfm, embedding_dim=DIM, **kw, **port_kw,
                          device="cpu", generator=generator
                          or torch.Generator().manual_seed(seed + 9))
    return jm, pm


def _sizes(name):
    kw = dict(MODELS[name])
    if name == "KSR":
        return dict(kw, num_users=N_USERS, n_entities=N_ENT)
    kw.update(num_users=N_USERS, n_entities=N_ENT, n_relations=N_REL)
    return kw


def _jax_init(name, jm, batch, kb, seed):
    key = jax.random.PRNGKey(seed)
    if name == "KSR":
        return _np(jm.init(key, batch, method=jm.full_scores)["params"])
    params = _np(jm.init(key, batch)["params"])
    if name == "MKR":               # the KG head, as JAX's pipeline adds it
        kg = _np(jm.init(jax.random.PRNGKey(seed + 1), kb,
                         method=jm.kg_loss)["params"])
        params = {**kg, **params}
    return params


def _models(name, seed=0):
    jkg, _, users, items = _world()
    jfm, pfm = _maps()
    kw = _sizes(name)
    jm, pm = _build(name, jfm, pfm, kw,
                    _graph_kwargs(name, jkg, users, items, True),
                    _graph_kwargs(name, jkg, users, items, False), seed)
    batch, kb = _batches(name, jkg, users, items)
    jparams = _jax_init(name, jm, batch, kb, seed)
    # zero biases drawn away from 0: on 0.01-scale tables a pre-activation
    # is ~1e-8, and KGAT's leaky ReLU would take its slope from the sign
    # of rounding noise
    rng = np.random.default_rng(seed + 3)
    jparams = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if not a.any() else a, jparams)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(jparams, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for key, v in pm.state_dict().items():
        assert not torch.equal(v, before[key]) \
            or bool((v == v.flatten()[0]).all()), key
    return jm, jparams, pm, batch, kb


# gradients that are 0 in exact arithmetic: the last cross & compress
# unit's item bias shifts every candidate's score alike, so a pairwise
# loss cancels it, and what is left is each package's rounding of terms
# far larger than the model's other gradients
NOISE = {"MKR": ("cc1.b_v",)}


def _check_grads(pm, jgrads, ploss, noise=()):
    want = from_jax_params(_np(jgrads), pm)
    params = list(pm.named_parameters())
    grads = torch.autograd.grad(ploss, [p for _, p in params],
                                allow_unused=True)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (n, p), g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        if n in noise:
            assert np.abs(g.numpy()).max() <= 1e-2 * top, n
            assert np.abs(want[n].numpy()).max() <= 1e-2 * top, n
            continue
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GTOL,
                                   atol=GTOL * top, err_msg=n)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=max(ATOL, RTOL * np.abs(want).max()),
                               err_msg=msg)


TRAINED = [n for n in MODELS if n != "KSR"]


@pytest.mark.parametrize("name", TRAINED)
def test_scores_and_grads_match_jax(name):
    jm, jparams, pm, batch, _ = _models(name)
    _close(pm(_t(batch)), jm.apply({"params": jparams}, batch), "scores")
    loss = jget_matching_loss("PairwiseLogisticLoss")
    jgrads = jax.grad(lambda p: loss(jm.apply({"params": p}, batch)))(
        jparams)
    _check_grads(pm, jgrads,
                 get_matching_loss("PairwiseLogisticLoss")(pm(_t(batch))),
                 NOISE.get(name, ()))


@pytest.mark.parametrize("name", ["CKE", "CFKG", "MKR", "KGAT", "KGIN",
                                  "MCCLK"])
def test_towers_match_jax(name):
    jm, jparams, pm, _, _ = _models(name)
    users = {"user_id": np.arange(N_USERS, dtype=np.int32)}
    items = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    for method, b in (("user_tower", users), ("item_tower", items)):
        _close(getattr(pm, method)(_t(b)),
               jm.apply({"params": jparams}, b, method=getattr(jm, method)),
               method)
    if name == "CFKG":
        _close(pm.full_scores_table(),
               jm.apply({"params": jparams}, method=jm.full_scores_table))


@pytest.mark.parametrize("name", ["CKE", "CFKG", "KTUP", "MKR", "KGAT",
                                  "RippleNet"])
def test_kg_loss_and_grads_match_jax(name):
    jm, jparams, pm, _, kb = _models(name)

    def jloss(p):
        return jm.apply({"params": p}, kb, method=jm.kg_loss)
    pm.eval()
    ploss = pm.kg_loss(_t(kb))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


def test_kgnnls_label_propagation_matches_jax():
    jm, jparams, pm, batch, _ = _models("KGNNLS")
    rng = np.random.default_rng(7)
    labels = (rng.random((B, N_ENT)) < 0.3).astype(np.float32)
    ids = batch["__item_ids__"][:, :2]
    targets = (rng.random((B, 2)) < 0.5).astype(np.float32)
    _close(pm.label_propagate(_t(batch), torch.from_numpy(ids),
                              torch.from_numpy(labels)),
           jm.apply({"params": jparams}, batch, ids, labels,
                    method=jm.label_propagate))

    def jloss(p):
        return jm.apply({"params": p}, batch, ids, labels, targets,
                        method=jm.ls_loss)
    ploss = pm.ls_loss(_t(batch), torch.from_numpy(ids),
                       torch.from_numpy(labels), torch.from_numpy(targets))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


@pytest.mark.parametrize("aggregator", ["sum", "neighbor", "concat"])
def test_kgcn_aggregators_match_jax(aggregator):
    jkg, _, users, items = _world()
    jfm, pfm = _maps()
    kw = dict(_sizes("KGCN"), aggregator=aggregator)
    jm, pm = _build("KGCN", jfm, pfm, kw,
                    _graph_kwargs("KGCN", jkg, users, items, True),
                    _graph_kwargs("KGCN", jkg, users, items, False), 1)
    batch, _ = _batches("KGCN", jkg, users, items)
    jparams = _jax_init("KGCN", jm, batch, None, 1)
    pm.load_state_dict(from_jax_params(jparams, pm))
    _close(pm(_t(batch)), jm.apply({"params": jparams}, batch))
    _close(pm.full_scores(_t(batch)),
           jm.apply({"params": jparams}, batch, method=jm.full_scores))


@pytest.mark.parametrize("term", ["kgin_independence", "mcclk_contrast"])
def test_intent_terms_match_jax(term):
    name = "KGIN" if term.startswith("kgin") else "MCCLK"
    jm, jparams, pm, batch, _ = _models(name)
    if name == "KGIN":
        def jloss(p):
            return jm.apply({"params": p}, method=jm.independence_loss)
        ploss = pm.independence_loss()
    else:
        def jloss(p):
            return jm.apply({"params": p}, batch, method=jm.contrastive_loss)
        ploss = pm.contrastive_loss(_t(batch))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


def test_ksr_matches_jax():
    jm, jparams, pm, batch, _ = _models("KSR")
    pm.eval()
    _close(pm.user_tower(_t(batch)),
           jm.apply({"params": jparams}, batch, method=jm.user_tower))
    want = jm.apply({"params": jparams}, batch, method=jm.full_scores)
    _close(pm.full_scores(_t(batch)), want)

    def jloss(p):
        s = jm.apply({"params": p}, batch, method=jm.full_scores)
        return -jnp.mean(jax.nn.log_softmax(s)[jnp.arange(B),
                                               batch["item_id"]])
    s = pm.full_scores(_t(batch))
    ploss = -torch.mean(torch.log_softmax(s, -1)[torch.arange(B),
                                                 torch.from_numpy(
                                                     batch["item_id"]).long()])
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)
