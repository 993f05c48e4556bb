"""The port's first-order sums on tiny BLIP-2 (48 targets over the ViT, T5
encoder and T5 decoder stacks) against the JAX package's
``first_order_group_sums``, partitioned and streamed, for every score
method; the tolerance and the paths are those of
tests/test_torch_first_order.py."""

import pytest

from tests.test_torch_first_order import NUM_MB, check_sums_match
from tests.torch_parity import FIRST_ORDER_METHODS, first_order_sums


@pytest.fixture(scope="module")
def blip2_sums():
    return first_order_sums("blip2", NUM_MB)


@pytest.mark.parametrize("method", FIRST_ORDER_METHODS)
@pytest.mark.parametrize("jax_path", ["partitioned", "streamed"])
@pytest.mark.parametrize("port_path", ["streamed", "plain"])
def test_blip2_group_sums_match_jax(blip2_sums, method, jax_path, port_path):
    tad, out = blip2_sums
    assert len(tad.targets()) == 48
    check_sums_match(tad, out, method, jax_path, port_path)
