"""The control fails a limit: the reference computed in TF32 in the program's
place, on the card, at smaller sizes than the cells' (their own sizes are
read by ``benchmark/calibrate.py``). Needs the card."""

import pytest

from benchmark import harness

SMALL = {
    "svgd_sin320_fit": {"traffic": {"n_tasks": 64}},
    "svgd_cauchy20_fit": {},
    "svgd_t5n200_fit": {"traffic": {"n_tasks": 3}},
    "mlap_sin20_metatest": {"traffic": {"test_tasks": 50}},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_the_tf32_control_fails_a_limit_and_the_program_none(card, name, seed):
    cell = harness.Cell(name, overrides=SMALL[name])
    driver = harness.driver_class(cell.traffic["driver"])(cell, seed, card)
    driver.setup(0)
    readings = driver.calibration(True)
    limits = cell.limits
    assert all(readings["sound"][k] <= v for k, v in limits.items()), readings["sound"]
    assert any(readings["control"][k] > v for k, v in limits.items()), readings["control"]
