"""Faults planted under a run, to show that ``correct`` catches them (the
tests on the CPU, `calibrate` on the card). Each takes ``setattr`` (the
tests pass pytest's ``monkeypatch.setattr``, which undoes it) and replaces
one function of the port; none is ever planted by `run`."""


def alter_answer(setattr):
    """Serving: each row's first served id replaced by its neighbour's."""
    from recbox_tpu_torch.retrieval.index import BruteForceMIPS
    search = BruteForceMIPS.search

    def altered(self, queries, topk=500):
        s, i = search(self, queries, topk)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % self.num_items
        return s, i
    setattr(BruteForceMIPS, "search", altered)


def half_queries(setattr):
    """Serving: half of a query's users searched, their results given to
    the rest."""
    import torch
    from recbox_tpu_torch.retrieval.index import BruteForceMIPS
    search = BruteForceMIPS.search

    def half(self, queries, topk=500):
        n = queries.shape[0]
        s, i = search(self, queries[:(n + 1) // 2], topk)
        return torch.cat([s, s])[:n], torch.cat([i, i])[:n]
    setattr(BruteForceMIPS, "search", half)


def shifted_ranks(setattr):
    """Serving: each row's best tenth of its top k left out, and the next
    tenth past the k-th served in its place (a selection off by m ranks,
    which the reference's (k + m)-th score cannot see)."""
    from recbox_tpu_torch.retrieval.index import BruteForceMIPS
    search = BruteForceMIPS.search

    def shifted(self, queries, topk=500):
        m = max(1, topk // 10)
        s, i = search(self, queries, topk + m)
        order = s.argsort(dim=1, descending=True)
        s, i = s.gather(1, order), i.gather(1, order)
        return s[:, m:].contiguous(), i[:, m:].contiguous()
    setattr(BruteForceMIPS, "search", shifted)


def state_unchanged(setattr):
    """Training: steps that compute everything and update nothing."""
    from recbox_tpu_torch.training import packed, trainer
    setattr(trainer._Optimizer, "_apply", lambda self, u: None)
    setattr(packed.PackedEmbeddingTrainer, "_apply_row_updates",
            lambda self, *a: None)


def half_batch(setattr):
    """Training: the loss a mean over the first half of each batch."""
    from recbox_tpu_torch.ops import losses
    bce = losses.binary_crossentropy

    def half(logits, labels, from_logits=True):
        n = logits.shape[0] // 2
        return bce(logits[:n], labels[:n], from_logits)
    setattr(losses, "binary_crossentropy", half)


def rows_moved_double(setattr):
    """Training: the row update added twice where B1 produces it."""
    from recbox_tpu_torch.training import packed
    update = packed.packed_adagrad_update_

    def twice(pack, ids, G, grads, lr, **kw):
        update(pack, ids, G, grads, lr, **kw)
        return update(pack, ids, G, grads, lr, **kw)
    setattr(packed, "packed_adagrad_update_", twice)


def stale_batch(setattr):
    """Training, on the card: every replay of the captured step reads the
    batch staged first in the call, not the one at the graph's cursor."""
    import torch
    from recbox_tpu_torch.training import graph

    def body(self):
        batch = {k: buf[0] for k, buf in self.inputs.items()}
        loss = self.trainer._train_step(batch)
        self.losses.index_copy_(0, self.cursor,
                                loss.reshape(1).to(torch.float32))
        self.cursor.add_(1)
    setattr(graph.StepGraph, "_body", body)


SERVING = (alter_answer, half_queries, shifted_ranks)
TRAINING = (state_unchanged, half_batch, rows_moved_double)
# the CPU runs `train_steps_fused` as eager steps, with no captured graph
CARD_TRAINING = (stale_batch,)
BY_NAME = {f.__name__: f for f in SERVING + TRAINING + CARD_TRAINING}
