"""``correct`` on the CPU at a small size: the program passes, and the
control (the port's next precision below the configuration's) and each
fault a cell can have, planted under a run, fail. On the card, the same
for the control and for the faults of the captured step at the cell's own
size."""

import pytest

from benchmark import faults
from benchmark.run import run_cell
from benchmark.spec import Spec
from benchmark.tests.sizes import small

SPEC = Spec()
SERVE = [n for n in sorted(SPEC.cells)
         if SPEC.config(SPEC.cell(n))["system"] == "two_tower_retrieval"]
TRAIN = [n for n in sorted(SPEC.cells)
         if SPEC.config(SPEC.cell(n))["system"] == "packed_ctr_training"]
SEED = 2 ** 31 + 977


def correct(cell: str, device: str = "cpu", control: bool = False,
            seed: int = SEED, full: bool = False) -> bool:
    cfg, traffic = (None, None) if full else small(SPEC, cell)
    out = run_cell(SPEC, cell, seed, 0.3, False, device=device, config=cfg,
                   traffic=traffic, control=control)
    limits = SPEC.limits(SPEC.cell(cell))
    return all(out.numbers[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_program_is_correct(cell):
    assert correct(cell)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_is_not_correct(cell):
    assert not correct(cell, control=True)


@pytest.mark.parametrize("fault", faults.SERVING)
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    assert not correct(cell)


@pytest.mark.parametrize("fault", faults.TRAINING)
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    assert not correct(cell)


@pytest.mark.card
@pytest.mark.parametrize("fault", faults.CARD_TRAINING)
@pytest.mark.parametrize("cell", TRAIN)
def test_graph_fault_is_not_correct_on_card(cell, fault, card, monkeypatch):
    """A fault of the captured step, which only the card replays, at the
    cell's own size."""
    fault(monkeypatch.setattr)
    assert not correct(cell, device=card, seed=3_000_000_201, full=True)


@pytest.mark.card
@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_is_not_correct_on_card(cell, card):
    """The control at the cell's own size, three seeds."""
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        assert not correct(cell, device=card, control=True, seed=seed,
                           full=True)
