"""Counted FLOPs of the port's dry run against the analytic model for the
mixture-of-experts family's five archs (the last five of the registry):
the check, its tolerances and its choice of pairs are
tests/test_torch_dryrun_flops.py's.
"""
import pytest

from repro_torch.configs import registry
from test_torch_dryrun_flops import cases, check_counted_flops


@pytest.mark.parametrize("arch,kind", cases(registry.ARCH_IDS[5:]))
def test_counted_flops_match_the_analytic_model(arch, kind):
    check_counted_flops(arch, kind)
