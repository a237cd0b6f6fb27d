"""The traffic copies are functions of the seed alone."""

import numpy as np
import pytest

from portbench.gen.templates import Scenario
from portbench.tests.small import QUINCY, STEADY


def _same_data(a, b):
    return (a.block_sizes == b.block_sizes and a.block_holders == b.block_holders
            and a.templates == b.templates)


def _same_traffic(a, b):
    return (np.array_equal(a.fill_templates, b.fill_templates)
            and np.array_equal(a.fill_jobs, b.fill_jobs))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_traffic_is_a_function_of_the_seed_and_data_of_the_deployment(seed):
    a, b, c = Scenario(QUINCY, seed), Scenario(QUINCY, seed), Scenario(QUINCY, seed + 1)
    assert _same_data(a, b) and _same_traffic(a, b)
    assert _same_data(a, c) and not _same_traffic(a, c)
    assert not _same_data(a, Scenario(dict(QUINCY, data_seed=8), seed))


@pytest.mark.parametrize("seed", [1, 2**33 + 1])
def test_round_draws_depend_on_seed_and_round_only(seed):
    a, b = Scenario(QUINCY, seed), Scenario(QUINCY, seed)
    b.refresh(1, 4)  # what happens in between does not move a round's draws
    for r in (0, 5, 1000):
        da, db = a.round_draws(r, 256, STEADY["churn"]), b.round_draws(r, 256, STEADY["churn"])
        assert np.array_equal(da[0], db[0]) and np.array_equal(da[1], db[1])
        assert da[2] == db[2]
    other = Scenario(QUINCY, seed + 1).round_draws(0, 256, STEADY["churn"])
    assert not np.array_equal(a.round_draws(0, 256, STEADY["churn"])[0], other[0])


def test_draws_follow_popularity():
    sc = Scenario(QUINCY, 3)
    tmpl = sc.draw_templates(np.random.default_rng(0), 200_000)
    freq = np.bincount(tmpl, minlength=len(sc.templates)) / tmpl.size
    assert np.abs(freq - sc.popularity).max() < 0.01
    assert all(2 <= len(t) <= 3 and t == sorted(t) for t in sc.templates)


def test_refresh_is_a_function_of_the_deployment_and_upkeep():
    a, b = Scenario(QUINCY, 9), Scenario(QUINCY, 10)
    a.refresh(2, 4)
    b.refresh(2, 4)
    assert a.templates == b.templates
    b.refresh(3, 4)
    assert a.templates != b.templates
