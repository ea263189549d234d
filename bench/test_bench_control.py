"""The control on the card: the reference in TF32 put in the program's
place must fail each configuration's limit, while the program passes it,
on three seeds at a size a test run holds (4 samples a step).  Skips
without a card; run it there with
``PYTHONPATH=src python -m pytest -q bench/test_bench_control.py``.
"""
import pytest

from bench import readings

SEEDS = (2 ** 31 + 3, 2 ** 31 + 5, 2 ** 31 + 7)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["distilbert.b64", "resnet50.b128"])
def test_control_fails_and_program_passes(card, cell):
    rows = list(readings.readings(cell, SEEDS, set(SEEDS), seconds=0.5,
                                  samples=4))
    assert len(rows) == len(SEEDS)
    for row in rows:
        assert row["program"] <= row["limit"] < row["control"], row
