"""The benchmark on the card (marker ``cuda``; skips without one): a short
run of a cell ends correct with every end-to-end metric, and a traced run
reads the device."""

import pytest

from mapbench.tests import tiny

pytestmark = pytest.mark.cuda


def test_short_run_on_the_card(card):
    from mapbench import run as run_mod
    out, _ = run_mod.run_cell(tiny.spec("ecoli-k12-100bp.sam-unique",
                                        genome_len=400000, pool=16384,
                                        batch=4096),
                              7, 3.0, trace=False, device=card)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["reads_per_s"]["value"] > 0


def test_traced_run_reads_the_device(card):
    from mapbench import run as run_mod
    out, _ = run_mod.run_cell(tiny.spec("snp-repeat25",
                                        genome_len=400000, pool=16384,
                                        batch=4096),
                              8, 4.0, trace=True, device=card)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert "b1_roofline" in out["metrics"]
    assert out["breakdown"]["device_ops"]
