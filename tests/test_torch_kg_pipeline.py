"""The knowledge pipeline of the port against the JAX package, on the CPU.

- `run_kg_experiment`: its KG batches are JAX's (``default_rng(seed + 7)``,
  one batch spent on JAX's initialisation of the KG heads, then one a KG
  step), bit for bit; a paired run with KGAT (the port started from JAX's
  initial weights, `test_torch_reranking.load_inits`, the zero biases
  drawn away from 0 in both) gives JAX's metrics within 1e-4.
- `run_experiment` over staged atomic ``.inter`` / ``.kg`` / ``.link``
  files: every knowledge name, and the sequential KSR, gives JAX's result
  (CKE and CFKG paired with JAX's initial weights, within 1e-4; MKR, whose
  KG head JAX draws apart from the trainer's params, the same metric keys
  and finite values) or raises the kind of error JAX's raises (a model
  whose graph arrays `run_experiment` does not fill: AttributeError;
  RippleNet without its ripple memories: KeyError; KTUP, a pair scorer
  without towers, in the retrieval evaluation: NotImplementedError).
- Each knowledge model's initial draw against JAX's over eight seeds, by
  distribution (`test_torch_ctr_extended_init._check_draws`), and the
  AttributeError of a model built without its graph arrays.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import recbox_tpu.training.trainer as jtrainer_mod
from recbox_tpu import quick_start as jqs
from recbox_tpu.data import knowledge as JK
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.data import knowledge as PK
from recbox_tpu_torch.models import knowledge as P
from test_torch_ctr_extended_init import _check_draws
from test_torch_knowledge import (
    MODELS, _batches, _build, _graph_kwargs, _maps, _sizes, _u2i, _world,
)
from test_torch_reranking import load_inits, record_jax_inits

KG_NAMES = ("CKE", "CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "KGAT",
            "RippleNet", "KGIN", "MCCLK", "KSR")
PAIRED = ("CKE", "CFKG")
ERRORS = {"KTUP": NotImplementedError, "KGCN": AttributeError,
          "KGNNLS": AttributeError, "KGAT": AttributeError,
          "RippleNet": KeyError, "KGIN": AttributeError,
          "MCCLK": AttributeError, "KSR": AttributeError}


def _stage(root, name="kgtoy", n_users=30, n_items=40, per_user=12, seed=0):
    """Atomic files of a toy dataset with a KG over its items."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\t"
                "timestamp:float\n")
        t = 0
        for u in range(n_users):
            for i in rng.choice(n_items, per_user, replace=False):
                t += 1
                f.write(f"u{u}\ti{i}\t{rng.integers(1, 6)}\t{t}\n")
    with open(os.path.join(d, f"{name}.link"), "w") as f:
        f.write("item_id:token\tentity_id:token\n")
        for i in range(n_items):
            f.write(f"i{i}\te{i}\n")
    with open(os.path.join(d, f"{name}.kg"), "w") as f:
        f.write("head_id:token\trelation_id:token\ttail_id:token\n")
        for i in range(n_items):
            f.write(f"e{i}\thas_cat\tc{i % 5}\n")
            f.write(f"e{i}\tby\tp{rng.integers(0, 8)}\n")
    return root


CFG = dict(epochs=2, batch_size=64, embedding_dim=8, eval_batch_size=64,
           monitor="Recall(k=20)", learning_rate=1e-2, kg_steps_per_epoch=3,
           kg_batch_size=32)


@pytest.mark.parametrize("name", KG_NAMES)
def test_run_experiment_knowledge_names_as_jax(monkeypatch, tmp_path, name):
    root = _stage(str(tmp_path))
    if name in ERRORS:
        with pytest.raises(ERRORS[name]):
            jqs.run_experiment(name, "kgtoy", data_dir=root, **CFG)
        with pytest.raises(ERRORS[name]):
            qs.run_experiment(name, "kgtoy", data_dir=root, device="cpu",
                              **CFG)
        return
    with record_jax_inits(monkeypatch) as inits:
        want = jqs.run_experiment(name, "kgtoy", data_dir=root, **CFG)
    if name in PAIRED:
        load_inits(monkeypatch, inits)
    got = qs.run_experiment(name, "kgtoy", data_dir=root, device="cpu",
                            **CFG)
    assert set(got) == set(want)
    for key in want:
        assert np.isfinite(got[key])
        if name in PAIRED:
            np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                       err_msg=key)


class _Recorder:
    """A numpy Generator that keeps every ``integers`` draw."""

    def __init__(self, gen, log):
        self._gen, self._log = gen, log

    def integers(self, *args, **kwargs):
        out = self._gen.integers(*args, **kwargs)
        self._log.append(np.array(out, copy=True))
        return out

    def __getattr__(self, name):
        return getattr(self._gen, name)


def _kgat_setup(seed=0):
    jkg, pkg, users, items = _world(seed)
    jfm, pfm = _maps()
    n_users = int(users.max()) + 1
    train = {"user_id": users.astype(np.int32),
             "item_id": items.astype(np.int32)}
    corpus = {"item_id": np.arange(jkg.n_items, dtype=np.int32)}
    vu = np.arange(n_users, dtype=np.int64)
    valid_items = np.random.default_rng(seed + 1).integers(
        0, jkg.n_items, n_users)
    valid_u2i = {int(u): [int(i)] for u, i in zip(vu, valid_items)}
    h, r, t = JK.collaborative_kg_edges(jkg, users, items, n_users)
    cfg = dict(CFG, model="KGAT", num_users=n_users,
               n_entities=jkg.n_entities, n_relations=jkg.n_relations,
               n_layers=2, kg_dim=4, ckg_heads=h, ckg_relations=r,
               ckg_tails=t, kg_batch_size=16, seed=seed + 5)
    jcfg = dict(cfg, ckg_heads=_static(h),
                ckg_relations=_static(r), ckg_tails=_static(t))
    # the collaborative KG's triples are KGAT's KG batches
    ckg = dict(heads=h.astype(np.int64), relations=np.maximum(r, 1),
               tails=t.astype(np.int64),
               n_entities=jkg.n_entities + n_users,
               n_relations=jkg.n_relations, n_items=jkg.n_items)
    args = lambda fm, kg: (fm, train, corpus, kg,
                           {"user_id": vu.astype(np.int32)}, vu,
                           _u2i(users, items), valid_u2i)
    return (cfg, jcfg, args(jfm, JK.KnowledgeGraph(**ckg)),
            args(pfm, PK.KnowledgeGraph(**ckg)))


def _static(a):
    from recbox_tpu.models.knowledge import StaticArray
    return StaticArray(a)


def test_run_kg_experiment_kgat_paired_with_jax(monkeypatch):
    cfg, jcfg, jargs, pargs = _kgat_setup()
    real = np.random.default_rng
    logs = {"jax": [], "port": []}
    side = ["jax"]

    def default_rng(seed=None):
        gen = real(seed)
        if seed == cfg["seed"] + 7:
            return _Recorder(gen, logs[side[0]])
        return gen

    # JAX's initial weights with the zero biases drawn away from 0: on
    # 0.01-scale tables the bi-interaction's pre-activations are ~1e-8 and
    # the leaky ReLU would take its slope from the sign of rounding noise
    inits = []
    orig = jtrainer_mod.Trainer.init

    def init(self, sample):
        orig(self, sample)
        rng = real(3)
        params = jax.tree_util.tree_map(
            lambda a: (np.array(a, copy=True) if np.asarray(a).any() else
                       rng.normal(0, 0.1, a.shape).astype(np.float32)),
            fnn.meta.unbox(self.params))
        self.params = jax.tree_util.tree_map(
            lambda a: jnp.array(a, copy=True), params)
        self.opt_state = self.tx.init(self.params)
        inits.append(params)

    monkeypatch.setattr(jtrainer_mod.Trainer, "init", init)
    monkeypatch.setattr(np.random, "default_rng", default_rng)
    want = jqs.run_kg_experiment(jcfg, *jargs)
    monkeypatch.setattr(jtrainer_mod.Trainer, "init", orig)
    assert len(inits) == 1
    load_inits(monkeypatch, inits)
    side[0] = "port"
    got = qs.run_kg_experiment(cfg, *pargs, device="cpu")
    # one batch for JAX's KG-head init, then kg_steps_per_epoch an epoch;
    # each batch draws its triples, then its corrupted tails
    assert len(logs["port"]) == len(logs["jax"]) == \
        2 * (1 + cfg["epochs"] * cfg["kg_steps_per_epoch"])
    for a, b in zip(logs["port"], logs["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_initial_draw_matches_jax(name):
    jkg, _, users, items = _world()
    jfm, pfm = _maps()
    kw = _sizes(name)
    batch, kb = _batches(name, jkg, users, items)
    jm, _ = _build(name, jfm, pfm, kw,
                   _graph_kwargs(name, jkg, users, items, True),
                   _graph_kwargs(name, jkg, users, items, False), 0)
    if name == "KSR":
        ksr = jm
        jm = type("KSRInit", (), {"init": lambda self, k, b: ksr.init(
            k, b, method=ksr.full_scores)})()
    elif name == "MKR":
        base = jm

        def merged(k, b):
            out = fnn.meta.unbox(base.init(k, b))
            kg = fnn.meta.unbox(base.init(k, kb, method=base.kg_loss))
            return {"params": {**kg["params"], **out["params"]}}
        jm = type("MKRInit", (), {"init": lambda self, k, b: merged(k, b)})()
    _check_draws(jm, lambda g: _build(
        name, jfm, pfm, kw, {}, _graph_kwargs(name, jkg, users, items,
                                              False), 0, generator=g)[1],
        batch)


@pytest.mark.parametrize("name", ["KGCN", "KGAT", "KGIN", "MCCLK", "KSR"])
def test_missing_graph_arrays_raise_attribute_error(name):
    _, pfm = _maps()
    with pytest.raises(AttributeError, match="graph array"):
        getattr(P, name)(pfm, embedding_dim=8, **_sizes(name),
                         device="cpu")
