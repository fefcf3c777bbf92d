"""Atomic dataset files — recbole's `.inter`/`.user`/`.item`/`.kg`/`.link`
TSV format.

Re-design of the loading half of recbole's Dataset
(`third_party/recbole/data/dataset/dataset.py:44-1200`): headers carry
typed columns (`user_id:token`, `rating:float`, `genres:token_seq`,
`vec:float_seq`); loading yields typed numpy columns; then value-interval
filtering, NaN fill, label-by-threshold, contiguous id remapping (0 = PAD,
real ids from 1 — the Tokenizer layout used across the framework), and the
bridge into `InteractionDataset` / `KnowledgeGraph`.

Own copy of `recbox_tpu/data/atomic.py` (numpy only). The reference does
all of this on pandas with mutable state; here each step is a pure
dict→dict function over numpy columns. `AtomicDataset.to_knowledge_graph`
builds the port's `data.knowledge.KnowledgeGraph`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_atomic_file", "load_atomic_dataset", "remap_tokens",
            "filter_by_value", "label_by_threshold", "AtomicDataset"]

TOKEN = "token"
TOKEN_SEQ = "token_seq"
FLOAT = "float"
FLOAT_SEQ = "float_seq"
_TYPES = (TOKEN, TOKEN_SEQ, FLOAT, FLOAT_SEQ)


def load_atomic_file(path: str, seq_sep: str = " ") -> Dict[str, np.ndarray]:
    """Parse one atomic TSV: header `name:type\t...`; returns
    {name: column}. token → str array, float → float32, *_seq → object
    array of lists (pad later at batch time)."""
    with open(path) as fh:
        header = fh.readline().rstrip("\r\n").split("\t")
        names, types = [], []
        for col in header:
            if ":" not in col:
                raise ValueError(f"{path}: header field {col!r} lacks :type")
            n, t = col.rsplit(":", 1)
            if t not in _TYPES:
                raise ValueError(f"{path}: unknown column type {t!r}")
            names.append(n)
            types.append(t)
        rows = [line.rstrip("\r\n").split("\t") for line in fh if line.strip()]
    cols: Dict[str, np.ndarray] = {}
    for j, (n, t) in enumerate(zip(names, types)):
        raw = [r[j] if j < len(r) else "" for r in rows]
        if t == TOKEN:
            cols[n] = np.asarray(raw, dtype=object)
        elif t == FLOAT:
            cols[n] = np.asarray(
                [float(v) if v not in ("", "None") else np.nan for v in raw],
                dtype=np.float32)
        elif t == TOKEN_SEQ:
            cols[n] = np.asarray(
                [v.split(seq_sep) if v else [] for v in raw], dtype=object)
        else:  # FLOAT_SEQ
            cols[n] = np.asarray(
                [[float(x) for x in v.split(seq_sep)] if v else []
                 for v in raw], dtype=object)
    return cols


def remap_tokens(columns: Sequence[np.ndarray],
                 vocab: Optional[Dict[str, int]] = None,
                 start: int = 0
                 ) -> Tuple[List[np.ndarray], Dict[str, int]]:
    """Shared contiguous remap across columns (recbole `_remap_ID_all`):
    ids start at 1; 0 is PAD. First-appearance order (recbole uses the same
    insertion-order semantics).

    New tokens are numbered from max(existing ids, ``start``) + 1 — NOT
    len(vocab)+1, which collides when ``vocab`` is pre-seeded with sparse
    ids (e.g. KG entities seeded with their linked item ids). ``start``
    reserves an id range (entities must not alias unlinked items)."""
    vocab = dict(vocab or {})
    nxt = max(max(vocab.values(), default=0), start)
    out = []
    for col in columns:
        ids = np.zeros(len(col), dtype=np.int64)
        for i, tok in enumerate(col):
            if tok not in vocab:
                nxt += 1
                vocab[tok] = nxt
            ids[i] = vocab[tok]
        out.append(ids)
    return out, vocab


def filter_by_value(cols: Dict[str, np.ndarray],
                    intervals: Mapping[str, Tuple[Optional[float], Optional[float]]]
                    ) -> Dict[str, np.ndarray]:
    """Keep rows whose float columns fall inside [lo, hi] (recbole
    val_interval filters)."""
    keep = np.ones(len(next(iter(cols.values()))), dtype=bool)
    for name, (lo, hi) in intervals.items():
        v = cols[name].astype(np.float64)
        if lo is not None:
            keep &= v >= lo
        if hi is not None:
            keep &= v <= hi
    return {k: v[keep] for k, v in cols.items()}


def label_by_threshold(cols: Dict[str, np.ndarray], field: str,
                       threshold: float, label_name: str = "label"
                       ) -> Dict[str, np.ndarray]:
    """rating ≥ threshold → 1 else 0 (recbole `_set_label_by_threshold`)."""
    out = dict(cols)
    out[label_name] = (cols[field].astype(np.float64)
                       >= threshold).astype(np.float32)
    return out


class AtomicDataset:
    """Loaded atomic dataset: inter/user/item (and optional kg/link) tables
    with shared user/item vocabularies.

    `load_atomic_dataset(dir, name)` expects `name.inter` (+ optional
    `name.user`, `name.item`, `name.kg`, `name.link`) — recbole's layout.
    """

    def __init__(self, inter, user=None, item=None, kg=None, link=None,
                 user_vocab=None, item_vocab=None, entity_vocab=None,
                 relation_vocab=None):
        self.inter = inter
        self.user = user
        self.item = item
        self.kg = kg
        self.link = link
        self.user_vocab = user_vocab or {}
        self.item_vocab = item_vocab or {}
        self.entity_vocab = entity_vocab or {}
        self.relation_vocab = relation_vocab or {}

    @property
    def num_users(self) -> int:
        return len(self.user_vocab) + 1   # + PAD row 0

    @property
    def num_items(self) -> int:
        return len(self.item_vocab) + 1

    def to_interactions(self, user_field="user_id", item_field="item_id",
                        rating_field=None, time_field=None):
        from recbox_tpu_torch.data.interactions import InteractionDataset
        kw = {}
        if rating_field and rating_field in self.inter:
            kw["ratings"] = self.inter[rating_field]
        if time_field and time_field in self.inter:
            kw["timestamps"] = self.inter[time_field]
        return InteractionDataset(self.inter[user_field],
                                  self.inter[item_field], **kw)

    def filter_interactions(self, min_rating: Optional[float] = None,
                            min_user_inter: int = 0,
                            min_item_inter: int = 0,
                            rating_field: str = "rating",
                            user_field: str = "user_id",
                            item_field: str = "item_id"
                            ) -> "AtomicDataset":
        """Filter interactions, then JOINTLY remap users, items, and KG
        entities so the item↔entity id spaces stay aligned.

        recbole semantics (`third_party/recbole/data/dataset/dataset.py:868`
        `_filter_by_inter_num` + `:1165` `_remap_ID_all` + kg_dataset.py):
        filtering happens BEFORE the remap, so after min_rating /
        iterative k-core pruning, surviving items are renumbered
        contiguously, linked KG entities inherit the surviving item's new
        id, and entities of DROPPED items become plain (non-item)
        entities numbered after the new item id space — exactly what a
        post-load remap of the union {remaining item tokens} ∪ {entity
        tokens} produces there. Returns a NEW AtomicDataset; `self` is
        untouched.
        """
        inter = dict(self.inter)
        n = len(inter[user_field])
        keep = np.ones(n, dtype=bool)
        if min_rating is not None:
            if rating_field not in inter:
                raise ValueError(f"min_rating needs a {rating_field!r} "
                                 "column in .inter")
            keep &= inter[rating_field].astype(np.float64) >= min_rating
        rows = np.flatnonzero(keep)
        u = inter[user_field][rows].astype(np.int64)
        i = inter[item_field][rows].astype(np.int64)
        # iterative k-core (recbole loops until stable)
        while len(rows) and (min_user_inter or min_item_inter):
            uc = np.bincount(u)
            ic = np.bincount(i)
            ok = (uc[u] >= min_user_inter) & (ic[i] >= min_item_inter)
            if ok.all():
                break
            rows, u, i = rows[ok], u[ok], i[ok]
        inter = {k: v[rows] for k, v in inter.items()}

        def contiguous(ids: np.ndarray) -> Dict[int, int]:
            # old ids were assigned in first-appearance order at load, so
            # ascending old id == original relative order
            return {int(o): r + 1 for r, o in enumerate(np.unique(ids))}

        user_map = contiguous(u)
        item_map = contiguous(i)
        inter[user_field] = np.asarray([user_map[int(x)] for x in u],
                                       np.int64)
        inter[item_field] = np.asarray([item_map[int(x)] for x in i],
                                       np.int64)

        def remap_table(table, field, mapping):
            if table is None:
                return None
            sel = np.asarray([int(x) in mapping for x in table[field]])
            out = {k: v[sel] for k, v in table.items()}
            out[field] = np.asarray([mapping[int(x)] for x in out[field]],
                                    np.int64)
            return out

        user = remap_table(self.user, user_field, user_map)
        item = remap_table(self.item, item_field, item_map)
        user_vocab = {t: user_map[o] for t, o in self.user_vocab.items()
                      if o in user_map}
        item_vocab = {t: item_map[o] for t, o in self.item_vocab.items()
                      if o in item_map}

        kg, link = self.kg, self.link
        entity_vocab: Dict[str, int] = {}
        if kg is not None:
            # entity remap: surviving linked items keep their (new) item
            # id; everything else — dropped-item entities AND pure
            # entities — is renumbered after the new item id space in
            # first-appearance order over the kg triples
            ent_map: Dict[int, int] = dict(item_map)
            nxt = len(item_map)
            kg = dict(kg)
            for key in ("head_id", "tail_id"):
                col = kg[key].astype(np.int64)
                out = np.zeros(len(col), np.int64)
                for r, e in enumerate(col):
                    e = int(e)
                    if e not in ent_map:
                        nxt += 1
                        ent_map[e] = nxt
                    out[r] = ent_map[e]
                kg[key] = out
            if link is not None:
                lid = link[item_field + "_id"].astype(np.int64) \
                    if item_field + "_id" in link else None
                if lid is not None:
                    sel = np.asarray([int(x) in item_map for x in lid])
                    link = {k: v[sel] for k, v in link.items()}
                    link[item_field + "_id"] = np.asarray(
                        [item_map[int(x)] for x in lid[sel]], np.int64)
            entity_vocab = {t: ent_map[o]
                            for t, o in self.entity_vocab.items()
                            if o in ent_map}
        return AtomicDataset(inter, user, item, kg, link,
                             user_vocab, item_vocab, entity_vocab,
                             dict(self.relation_vocab))

    def to_knowledge_graph(self):
        """The loaded .kg as a `data.knowledge.KnowledgeGraph`: entities
        sized to cover the item and entity vocabularies and every id in
        the triples, relations numbered from 1 (0 = interact)."""
        from recbox_tpu_torch.data.knowledge import KnowledgeGraph
        if self.kg is None:
            raise ValueError("no .kg file was loaded")
        n_entities = max(len(self.item_vocab), len(self.entity_vocab)) + 1
        return KnowledgeGraph(
            heads=self.kg["head_id"], relations=self.kg["relation_id"],
            tails=self.kg["tail_id"],
            n_entities=int(max(n_entities,
                               self.kg["head_id"].max() + 1,
                               self.kg["tail_id"].max() + 1)),
            n_relations=len(self.relation_vocab) + 1,
            n_items=self.num_items)


def load_atomic_dataset(data_dir: str, name: str,
                        user_field: str = "user_id",
                        item_field: str = "item_id") -> AtomicDataset:
    """Load `name.inter` (+ sidecar files), remap user/item/entity tokens to
    contiguous ids shared across tables (recbole's `_remap_ID_all` with the
    item↔entity `.link` merge)."""
    def path(ext):
        return os.path.join(data_dir, f"{name}.{ext}")

    inter = load_atomic_file(path("inter"))
    user = load_atomic_file(path("user")) if os.path.exists(path("user")) else None
    item = load_atomic_file(path("item")) if os.path.exists(path("item")) else None
    kg = load_atomic_file(path("kg")) if os.path.exists(path("kg")) else None
    link = load_atomic_file(path("link")) if os.path.exists(path("link")) else None

    # user remap across .inter and .user
    ucols = [inter[user_field]] + ([user[user_field]] if user else [])
    remapped, user_vocab = remap_tokens(ucols)
    inter[user_field] = remapped[0]
    if user:
        user[user_field] = remapped[1]

    # item remap across .inter, .item, and the .link item side
    icols = [inter[item_field]]
    if item:
        icols.append(item[item_field])
    if link is not None:
        icols.append(link[item_field])
    remapped, item_vocab = remap_tokens(icols)
    inter[item_field] = remapped[0]
    k = 1
    if item:
        item[item_field] = remapped[k]
        k += 1
    entity_vocab: Dict[str, int] = {}
    relation_vocab: Dict[str, int] = {}
    if kg is not None:
        # entities share the item id space through .link (items = entities)
        if link is not None:
            link[item_field + "_id"] = remapped[k]
            # seed entity vocab so linked entities get their item's id
            for ent, iid in zip(link["entity_id"], link[item_field + "_id"]):
                entity_vocab[ent] = int(iid)
        # unlinked entities start AFTER the whole item id space so they can
        # never alias an (unlinked) item id
        (kg_h, kg_t), entity_vocab = remap_tokens(
            [kg["head_id"], kg["tail_id"]], vocab=entity_vocab,
            start=len(item_vocab))
        (kg_r,), relation_vocab = remap_tokens([kg["relation_id"]])
        kg = dict(kg)
        kg["head_id"], kg["tail_id"], kg["relation_id"] = kg_h, kg_t, kg_r
    return AtomicDataset(inter, user, item, kg, link,
                         user_vocab, item_vocab, entity_vocab,
                         relation_vocab)
