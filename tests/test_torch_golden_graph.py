"""The port's CLI on the CPU against every graph entry of
tst/golden/iteration_counts.json (bjacobi and the GenEO matrix, dual and
nodal partitions): iterations, coarse dimension and Nicolaides count
equal.  No JAX here: the pinned counts are the reference."""

import pytest

from _torch_golden import golden_cases, run_case

CASES = golden_cases("graph")


@pytest.mark.parametrize("name,args,want", CASES, ids=[c[0] for c in CASES])
def test_cli_reproduces_golden_counts(name, args, want):
    assert run_case(args) == want
