"""Knowledge-graph data structures.

Counterpart of `recbox_tpu/data/knowledge.py`: a frozen triple store and
the static-shape structures the knowledge models read, each JAX's numpy
draw for draw:

  * the fixed-size neighbour tables (n_entities, K) of KGCN / KGNNLS
    (`build_neighbor_table`);
  * RippleNet's per-user ripple memories (U, n_hops, n_memory)
    (`build_ripple_sets`);
  * the collaborative KG of KGAT: interactions as the reserved relation
    ``INTERACT_RELATION`` (0), users after the entities
    (`collaborative_kg_edges`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["KnowledgeGraph", "build_neighbor_table", "build_ripple_sets",
           "collaborative_kg_edges", "INTERACT_RELATION"]

INTERACT_RELATION = 0  # the relation of user→item edges in the CKG


@dataclasses.dataclass(frozen=True)
class KnowledgeGraph:
    """Frozen triple store: heads / relations / tails (E,) and the sizes.

    Entities are 0..n_entities−1, the items the entities 0..n_items−1 (the
    .link remap is applied before). Relations start at 1; 0 is the
    collaborative KG's interact relation.
    """

    heads: np.ndarray
    relations: np.ndarray
    tails: np.ndarray
    n_entities: int
    n_relations: int           # the interact relation included
    n_items: int

    def __post_init__(self):
        if not len(self.heads) == len(self.relations) == len(self.tails):
            raise ValueError(
                f"heads, relations and tails differ in length: "
                f"{len(self.heads)}, {len(self.relations)}, "
                f"{len(self.tails)}")
        if len(self.relations) and self.relations.min() < 1:
            raise ValueError("relation ids must start at 1 (0 = interact)")

    @property
    def n_triples(self) -> int:
        return len(self.heads)

    def with_inverse(self) -> "KnowledgeGraph":
        """The graph with each triple's inverse added, at relation id
        r + n_relations − 1 (recbole's kg_reverse_r)."""
        inv_rel = self.relations + (self.n_relations - 1)
        return KnowledgeGraph(
            heads=np.concatenate([self.heads, self.tails]),
            relations=np.concatenate([self.relations, inv_rel]),
            tails=np.concatenate([self.tails, self.heads]),
            n_entities=self.n_entities,
            n_relations=2 * self.n_relations - 1,
            n_items=self.n_items)


def _sorted_by_head(kg: KnowledgeGraph):
    order = np.argsort(kg.heads, kind="stable")
    h = kg.heads[order]
    starts = np.searchsorted(h, np.arange(kg.n_entities), side="left")
    ends = np.searchsorted(h, np.arange(kg.n_entities), side="right")
    return h, kg.relations[order], kg.tails[order], starts, ends


def build_neighbor_table(kg: KnowledgeGraph, n_neighbors: int,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(n_entities, K) entity and relation neighbour tables, K out-triples
    drawn uniformly (with replacement only when the degree is below K); an
    entity without out-triples loops to itself on the interact
    relation."""
    rng = np.random.default_rng(seed)
    _, r, t, starts, ends = _sorted_by_head(kg)
    ent_tab = np.zeros((kg.n_entities, n_neighbors), np.int32)
    rel_tab = np.zeros((kg.n_entities, n_neighbors), np.int32)
    for e in range(kg.n_entities):
        deg = ends[e] - starts[e]
        if deg == 0:
            ent_tab[e] = e
            rel_tab[e] = INTERACT_RELATION
            continue
        idx = rng.choice(np.arange(starts[e], ends[e]), size=n_neighbors,
                         replace=deg < n_neighbors)
        ent_tab[e] = t[idx]
        rel_tab[e] = r[idx]
    return ent_tab, rel_tab


def build_ripple_sets(kg: KnowledgeGraph, user_items: Dict[int, list],
                      n_hops: int = 2, n_memory: int = 16,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Per-user ripple memories: hop 0 starts from the user's items, hop k
    takes triples whose heads are hop k−1's tails, n_memory of them drawn
    (with replacement when fewer). An empty hop > 0 copies the hop before
    it; an empty hop 0 is all-zero triples. (U, n_hops, n_memory) heads /
    relations / tails, and the sorted ``users``."""
    rng = np.random.default_rng(seed)
    h_sorted, r_sorted, t_sorted, starts, ends = _sorted_by_head(kg)
    users = sorted(user_items)
    n_users = len(users)
    heads = np.zeros((n_users, n_hops, n_memory), np.int32)
    rels = np.zeros((n_users, n_hops, n_memory), np.int32)
    tails = np.zeros((n_users, n_hops, n_memory), np.int32)
    for ui, u in enumerate(users):
        seeds = list(user_items[u])
        for hop in range(n_hops):
            cand = []
            for s in seeds:
                if s < kg.n_entities:
                    cand.extend(range(starts[s], ends[s]))
            if not cand:
                if hop > 0:
                    heads[ui, hop] = heads[ui, hop - 1]
                    rels[ui, hop] = rels[ui, hop - 1]
                    tails[ui, hop] = tails[ui, hop - 1]
                    seeds = list(tails[ui, hop])
                else:
                    heads[ui, hop] = 0
                    rels[ui, hop] = 0
                    tails[ui, hop] = 0
                    seeds = [0]
                continue
            cand = np.asarray(cand)
            pick = rng.choice(cand, size=n_memory,
                              replace=len(cand) < n_memory)
            heads[ui, hop] = h_sorted[pick]
            rels[ui, hop] = r_sorted[pick]
            tails[ui, hop] = t_sorted[pick]
            seeds = list(tails[ui, hop])
    return {"users": np.asarray(users, np.int32),
            "heads": heads, "relations": rels, "tails": tails}


def collaborative_kg_edges(kg: KnowledgeGraph, user_ids, item_ids,
                           num_users: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """KGAT's collaborative KG (heads, relations, tails) int32: the KG's
    triples, then user → item and item → user edges on the interact
    relation, the users offset by n_entities."""
    u = np.asarray(user_ids)
    if num_users and len(u) and int(u.max()) >= num_users:
        raise ValueError(
            f"user id {int(u.max())} >= num_users={num_users}: KGAT sizes "
            "its node table as n_entities + num_users")
    u = u + kg.n_entities
    i = np.asarray(item_ids)
    heads = np.concatenate([kg.heads, u, i])
    rels = np.concatenate([kg.relations,
                           np.full(len(u), INTERACT_RELATION, np.int64),
                           np.full(len(u), INTERACT_RELATION, np.int64)])
    tails = np.concatenate([kg.tails, i, u])
    return (heads.astype(np.int32), rels.astype(np.int32),
            tails.astype(np.int32))
