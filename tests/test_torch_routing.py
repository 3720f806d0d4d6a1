"""Eco and weighted routing, bit for bit (CPU).

``tests/test_torch_algos.py``'s harness (the port's plain step against the
JAX engine's scan with the reference's arrival tables, two chunks) for
``eco_route`` under its three objectives and ``--router-weights`` under
default_policy and joint_nf, on the duo fleet and on the bridged world
that crosses into an hour of price 0 with a DC free of carbon (eco's cost
scores all 0 there, its carbon scores 0 at that DC).
"""

import pytest

from test_torch_algos import WEIGHTS, check_case

CASES = {
    # with a power cap the log tick downclocks idle DCs to index 0
    "eco_route/energy": ("eco_route", "duo", dict(power_cap=100.0), False),
    "eco_route/carbon": ("eco_route", "duo", dict(eco_objective="carbon"), True),
    "eco_route/cost": ("eco_route", "duo", dict(eco_objective="cost",
                                                power_cap=100.0), True),
    "weighted/default_policy": ("default_policy", "duo",
                                dict(router_weights=WEIGHTS), False),
    "weighted/joint_nf": ("joint_nf", "duo", dict(router_weights=WEIGHTS), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_chunks_bit_identical(case):
    check_case(*CASES[case])
