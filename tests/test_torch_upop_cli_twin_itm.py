"""The port's UPop launcher against the JAX launchers' flow for the NLVR
(twin cross-attention) and retrieval (ITM) heads: the comparison and its
bounds are tests/test_torch_upop_cli.py's ``check_head``."""

import pytest

from tests.test_torch_upop_cli import check_head
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("head", ["nlvr", "retrieval"])
def test_upop_launcher_matches_the_jax_flow(tmp_path, monkeypatch, head):
    check_head(tmp_path, monkeypatch, head)
