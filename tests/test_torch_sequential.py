"""Port SASRec full-softmax training against the JAX package, on the CPU.

Same numpy inputs through both packages (vocab 41, D = 16, L = 8, 2 layers,
2 heads, dropout 0: the two dropout streams cannot match), the flax params
carried onto the port by `interop.from_jax_params`. Kernel B2 runs its
plain version here; JAX's runs in Pallas interpret mode.

Tolerances: f32 forward, `full_scores` and their gradients within rtol
1e-5 (other summation orders). bf16 compute rounds at other places in the
two frameworks (torch's CPU bf16 matmul adds the bias before its one
rounding, its softmax rounds once), so the bf16 forward agrees within 2e-2
of the largest value. `fused_ce_loss`: the JAX kernel sums its exp terms
rounded to bf16 (its MXU row-sum, `fused_ce.py:122-129`) and the port sums
them in f32, so the loss agrees within 1e-3 relative (a bf16 rounding of each
term, ~2^-9, biased by the sum) and within 1e-5 of the XLA formulation
itself; gradients within 0.5% of the largest in f32 compute, because p
rounds to bf16 before the products and a rounding can fall either side of
a tie, and within the bf16 forward's 2e-2 in bf16 compute. One
trainer step: Adam's first update is lr · g / (|g| + 1e-8), so an element
whose gradient lies within a few 1e-8 of zero may move anywhere in
[-lr, lr] on either side: at most 1% of the elements (5% in bf16
compute, whose roundings leave more gradients near zero differing) may
differ by more than 2e-5 + 1e-4 relative, and none by more than 2 lr = 2e-3; the loss
agrees within 1e-3 relative, the fused loss's bound.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.data import ArrayLoader as JArrayLoader
from recbox_tpu.data.sequential import leave_one_out_split as jloo
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.sequential.models import SASRec as JSASRec
from recbox_tpu.models.sequential.models import _last_valid as jlast_valid
from recbox_tpu.models.sequential.models import right_align_to_left as jralign
from recbox_tpu.ops import full_softmax_loss as jfull_softmax_loss
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.data import ArrayLoader
from recbox_tpu_torch.data.sequential import (
    build_sliding_windows, group_user_sequences, leave_one_out_split,
)
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.models.sequential import (
    NARM, SASRec, right_align_to_left,
)
from recbox_tpu_torch.models.sequential.models import _last_valid
from recbox_tpu_torch.nn.core import Dropout
from recbox_tpu_torch.ops.losses import binary_crossentropy, full_softmax_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig

N_ITEMS, DIM, L, B = 40, 16, 8, 24


def _fm(FM, FS, n_items=N_ITEMS, dim=DIM):
    return FM("seq", (FS("item_id", "categorical", source="item",
                         vocab_size=n_items + 1, embedding_dim=dim),),
              query_index="user_id", corpus_index="item_id",
              num_items=n_items + 1)


def _batch(seed, b=B):
    """Left-padded histories of random lengths (some rows fully padded
    but one item) and next-item targets."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, b).astype(np.int32)
    seq = rng.integers(1, N_ITEMS + 1, (b, L)).astype(np.int32)
    seq[np.arange(L)[None, :] < (L - lens)[:, None]] = 0
    return {"item_seq": seq, "seq_len": lens,
            "item_id": rng.integers(1, N_ITEMS + 1, b).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _pair(compute_dtype="float32", n_layers=2, dropout=0.0):
    kw = dict(embedding_dim=DIM, max_seq_len=L, n_layers=n_layers,
              n_heads=2, dropout=dropout, compute_dtype=compute_dtype)
    jm = JSASRec(feature_map=_fm(JFeatureMap, JFeatureSpec), **kw)
    pm = SASRec(_fm(FeatureMap, FeatureSpec), device="cpu", **kw)
    return jm, pm


def _transplant(jm, pm, batch):
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch,
                              method=jm.full_scores)["params"])
    pm.load_state_dict(from_jax_params(params, pm))
    return params


def _rel_close(got, want, rel, atol=0.0):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    assert err <= rel * float(np.max(np.abs(want))) + atol, (err, rel)


# -- 1. data ------------------------------------------------------------------

def test_sequential_data_matches_jax():
    rng = np.random.default_rng(0)
    users = rng.integers(0, 20, 300)
    items = rng.integers(1, 50, 300)
    ts = rng.integers(0, 1000, 300)
    seqs = group_user_sequences(users, items, ts)
    from recbox_tpu.data.sequential import group_user_sequences as jgroup
    jseqs = jgroup(users, items, ts)
    assert seqs.keys() == jseqs.keys()
    for k in seqs:
        np.testing.assert_array_equal(seqs[k], jseqs[k])
    for a, b in zip(leave_one_out_split(seqs, max_len=6),
                    jloo(jseqs, max_len=6)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    out = build_sliding_windows({7: np.array([1, 2, 3, 4])}, max_len=3)
    np.testing.assert_array_equal(out["item_seq"][0], [0, 0, 1])
    seq = np.array([[0, 0, 1, 2], [1, 2, 3, 4]], np.int32)
    ln = np.array([2, 4], np.int32)
    np.testing.assert_array_equal(
        right_align_to_left(torch.from_numpy(seq), torch.from_numpy(ln)),
        np.asarray(jralign(jnp.asarray(seq), jnp.asarray(ln))))
    h = rng.normal(size=(2, 4, 3)).astype(np.float32)
    ln0 = np.array([0, 3], np.int32)          # an empty row takes position 0
    np.testing.assert_array_equal(
        _last_valid(torch.from_numpy(h), torch.from_numpy(ln0)),
        np.asarray(jlast_valid(jnp.asarray(h), jnp.asarray(ln0))))


# -- 2. the model ---------------------------------------------------------------

def test_sasrec_param_tree_maps_onto_port():
    """Every flax param fills one port param and none is left over."""
    jm, pm = _pair()
    params = _transplant(jm, pm, _batch(0))
    flat = jax.tree_util.tree_leaves(params)
    assert len(flat) == len(pm.state_dict()) == 36
    w = params["sasrec"]["encoder"]["q1"]["kernel"]              # (D, H, K)
    np.testing.assert_array_equal(
        pm.sasrec.encoder.q1.weight.detach().numpy(),
        w.reshape(DIM, -1).T)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_sasrec_forward_matches_jax(compute_dtype):
    jm, pm = _pair(compute_dtype)
    batch = _batch(1)
    params = _transplant(jm, pm, batch)
    tb = _tb(batch)
    for method in ("user_tower", "full_scores"):
        want = np.asarray(jm.apply({"params": params}, batch,
                                   method=getattr(jm, method)))
        got = getattr(pm, method)(tb).detach()
        assert got.dtype == torch.float32 and got.shape == want.shape
        if compute_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=method)
        else:
            _rel_close(got.numpy(), want, 2e-2)


def test_sasrec_padded_query_positions_stay_finite():
    """A fully padded history row still gives a finite vector: the -1e9
    mask (never -inf) gives its padded queries a uniform softmax."""
    _, pm = _pair()
    batch = _batch(2)
    batch["item_seq"][0] = 0
    batch["seq_len"][0] = 0
    out = pm.user_tower(_tb(batch))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_sasrec_fused_ce_loss_and_grads_match_jax(compute_dtype):
    jm, pm = _pair(compute_dtype)
    batch = _batch(3)
    params = _transplant(jm, pm, batch)

    def jloss(p):
        return jm.apply({"params": p}, batch, method=jm.fused_ce_loss)

    def jxla(p):
        s = jm.apply({"params": p}, batch, method=jm.full_scores)
        return jfull_softmax_loss(s, batch["item_id"])

    jl, jg = jax.value_and_grad(jloss)(params)
    loss = pm.fused_ce_loss(_tb(batch))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-3 * abs(float(jl))
    if compute_dtype == "bfloat16":
        # under bf16 compute the fused loss is the full-scores CE
        assert abs(float(loss) - float(jxla(params))) <= \
            1e-5 * abs(float(jl))
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    # the k biases have an exactly-zero gradient (softmax ignores a shift
    # shared by all keys): both sides give rounding noise there, ~1e-12 in
    # f32 and ~1e-7 in bf16, held to 1e-4 of the largest gradient
    top = max(float(g.abs().max()) for g in expect.values())
    for k, g in expect.items():
        _rel_close(named[k].grad.numpy(), g.numpy(),
                   5e-3 if compute_dtype == "float32" else 2e-2,
                   atol=1e-4 * top)
    # the full-scores path through the port's own CE
    pm.zero_grad()
    full = full_softmax_loss(pm.full_scores(_tb(batch)),
                             _tb(batch)["item_id"])
    if compute_dtype == "bfloat16":
        assert abs(float(full) - float(loss)) <= 1e-5 * abs(float(loss))


@pytest.mark.parametrize("train_method,compute_dtype", [
    ("fused_ce_loss", "float32"), ("fused_ce_loss", "bfloat16"),
    ("full_scores", "float32")])
def test_trainer_step_matches_jax(train_method, compute_dtype):
    jm, pm = _pair(compute_dtype)
    if train_method == "fused_ce_loss":
        jloss, ploss = (lambda o, b: o), (lambda o, b: o)
    else:
        jloss = lambda o, b: jfull_softmax_loss(o, b["item_id"])  # noqa
        ploss = lambda o, b: full_softmax_loss(o, b["item_id"])   # noqa
    cfg = dict(learning_rate=1e-3, monitor="hit")
    jt = JTrainer(jm, jloss, JTrainerConfig(**cfg), train_method=train_method)
    pt = Trainer(pm, ploss, TrainerConfig(**cfg), device="cpu",
                 train_method=train_method)
    batch = _batch(4)
    jt.init(batch)
    pt.init(batch)
    pm.load_state_dict(from_jax_params(_np_tree(jt.params), pm))
    jl = float(jt.train_step(batch))
    pl_ = float(pt.train_step(batch))
    np.testing.assert_allclose(pl_, jl, rtol=1e-3)
    expect = from_jax_params(_np_tree(jt.params), pm)
    n = bad = 0
    for k, v in pm.state_dict().items():
        err = np.abs(v.numpy() - expect[k].numpy())
        assert float(err.max()) <= 2e-3, k
        n += err.size
        bad += int(np.sum(err > 2e-5 + 1e-4 * np.abs(expect[k].numpy())))
    assert bad <= (0.01 if compute_dtype == "float32" else 0.05) * n, \
        (bad, n)


@pytest.mark.parametrize("emb_reg,net_reg", [(10.0, 0.0), (0.0, 10.0),
                                             (10.0, 0.1)])
def test_trainer_regularizers_match_jax(emb_reg, net_reg):
    """One SASRec step with the regularizers on, f32, dropout 0, against
    the JAX `Trainer` on transplanted params. JAX takes the top-level
    ``emb_item`` as the embedding table (a component starting ``emb_``)
    and leaves it out of the net penalty. Adam's first step moves each
    element by about ±lr, so a penalty on the wrong tensor flips the sign
    of many of emb_item's updates, each a 2e-3 error: emb_item is held
    element by element, the rest as in `test_trainer_step_matches_jax`."""
    jm, pm = _pair("float32")
    cfg = dict(learning_rate=1e-3, monitor="hit",
               embedding_regularizer=emb_reg, net_regularizer=net_reg)
    jt = JTrainer(jm, lambda o, b: o, JTrainerConfig(**cfg),
                  train_method="fused_ce_loss")
    pt = Trainer(pm, lambda o, b: o, TrainerConfig(**cfg), device="cpu",
                 train_method="fused_ce_loss")
    batch = _batch(7)
    jt.init(batch)
    pt.init(batch)
    pm.load_state_dict(from_jax_params(_np_tree(jt.params), pm))
    jl = float(jt.train_step(batch))
    pl_ = float(pt.train_step(batch))
    np.testing.assert_allclose(pl_, jl, rtol=1e-3)
    expect = from_jax_params(_np_tree(jt.params), pm)
    n = bad = 0
    for k, v in pm.state_dict().items():
        err = np.abs(v.numpy() - expect[k].numpy())
        assert float(err.max()) <= 2e-3, k
        n += err.size
        bad += int(np.sum(err > 2e-5 + 1e-4 * np.abs(expect[k].numpy())))
    assert bad <= 0.01 * n, (bad, n)
    np.testing.assert_allclose(pm.emb_item.detach().numpy(),
                               expect["emb_item"].numpy(), rtol=1e-4,
                               atol=2e-5)


def test_fused_ce_under_mesh_raises_and_unported_encoders(tmp_path):
    _, pm = _pair()
    with pytest.raises(ValueError, match="single-shard"):
        Trainer(pm, lambda o, b: o, TrainerConfig(), mesh=object(),
                device="cpu", train_method="fused_ce_loss")
    # the logits' protocol runs under a mesh (parallel/): a gloo world of
    # one here
    import torch.distributed as dist
    from recbox_tpu_torch.parallel import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        t = Trainer(pm, lambda o, b: o, TrainerConfig(), mesh=mesh,
                    device="cpu", train_method="full_scores")
        assert t.mesh is mesh and t.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    # the encoders are ported (tests/test_torch_sequential_zoo.py),
    # pretraining (tests/test_torch_pretrain.py) and the knowledge stage's
    # KSR (tests/test_torch_knowledge.py): none of the stage raises
    assert NARM(_fm(FeatureMap, FeatureSpec), device="cpu").right_align
    from recbox_tpu_torch.models.registry import get_model
    assert get_model("S3Rec")[0].__name__ == "S3Rec"
    assert get_model("KSR") == (get_model("KSR")[0], "sequential")
    assert get_model("KSR")[0].__module__.startswith(
        "recbox_tpu_torch.models.knowledge")


# -- 3. learning ----------------------------------------------------------------

def _markov(n_items=40, n_users=200, seq_len=12, seed=3):
    """next item = (current + 1) mod n: pure sequence signal."""
    rng = np.random.default_rng(seed)
    seqs = {}
    for u in range(n_users):
        start = rng.integers(1, n_items + 1)
        seqs[u] = np.array([(start + k - 1) % n_items + 1
                            for k in range(seq_len)])
    return seqs


def test_sasrec_learns_markov_fused_ce():
    """Port of `test_sasrec_learns_markov_fused_ce`
    (`tests/test_sequential.py:144-163`): the whole train loop through
    `fused_ce_loss` (B2's plain version here) reaches hit@1 > 0.8."""
    train, valid, _ = leave_one_out_split(_markov(), max_len=8)
    fm = _fm(FeatureMap, FeatureSpec, dim=32)
    model = SASRec(fm, embedding_dim=32, max_seq_len=8, n_layers=1,
                   n_heads=2, dropout=0.0, compute_dtype="bfloat16",
                   generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(model, lambda out, b: out,
                      TrainerConfig(learning_rate=5e-3), device="cpu",
                      train_method="fused_ce_loss")
    loader = ArrayLoader(train, batch_size=256, drop_last=True, seed=0)
    for _ in range(6):
        for batch in loader:
            batch.pop("__mask__", None)
            trainer.train_step(batch)
    model.eval()
    with torch.no_grad():
        scores = model.full_scores(_tb({k: valid[k] for k in
                                        ("item_seq", "seq_len")}))
    hit = float(np.mean(scores.argmax(-1).numpy() == valid["item_id"]))
    assert hit > 0.8, hit


# -- 4. R1: dropout from the trainer's generator ----------------------------------

def _sasrec_trainer(seed):
    _, pm = _pair(dropout=0.3)
    return Trainer(pm, lambda o, b: o, TrainerConfig(seed=seed),
                   device="cpu", train_method="fused_ce_loss"), _batch(5)


def _deepfm_trainer(seed):
    specs = tuple(FeatureSpec(f"c{i}", "categorical", vocab_size=16,
                              embedding_dim=4) for i in range(3))
    fm = FeatureMap("t", specs, labels=("click",))
    model = DeepFM(fm, embedding_dim=4, hidden_units=(8, 8), dropout=0.3,
                   feature_major_compute=True, device="cpu")
    rng = np.random.default_rng(6)
    batch = {f"c{i}": rng.integers(0, 16, 64).astype(np.int32)
             for i in range(3)}
    batch["click"] = rng.integers(0, 2, 64).astype(np.float32)
    return Trainer(model, lambda o, b: binary_crossentropy(o, b["click"]),
                   TrainerConfig(seed=seed), device="cpu"), batch


@pytest.mark.parametrize("make", [_sasrec_trainer, _deepfm_trainer],
                         ids=["sasrec", "deepfm"])
def test_dropout_follows_the_trainer_seed(make):
    """Same seed: bit-identical losses over 3 steps, whatever torch's
    global generator does between them; another seed differs."""
    def run(seed, reseed_global):
        t, batch = make(seed)
        losses = []
        for step in range(3):
            if reseed_global:
                torch.manual_seed(1000 + step)
            losses.append(float(t.train_step(batch)))
        return losses

    a = run(11, False)
    assert a == run(11, True)
    assert a != run(12, False)
    t, _ = make(11)
    drops = [m for m in t.model.modules() if isinstance(m, Dropout)]
    assert drops and all(m.p == 0.3 for m in drops)


def test_dropout_semantics_and_missing_generator():
    d = Dropout(0.25)
    x = torch.ones(4000)
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    d.eval()
    assert d(x) is x
    assert Dropout(0.0).train()(x) is x


# -- 5. loader parity -------------------------------------------------------------

def test_markov_batches_match_jax_loader():
    train, _, _ = leave_one_out_split(_markov(), max_len=8)
    ours = list(ArrayLoader(train, batch_size=256, drop_last=True, seed=0))
    theirs = list(JArrayLoader(train, batch_size=256, drop_last=True,
                               seed=0))
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        for k in ("item_seq", "seq_len", "item_id"):
            np.testing.assert_array_equal(a[k], b[k])
