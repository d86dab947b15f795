"""The port's fused plan training ResNet50 against the JAX package's
fused graph, on the CPU: two ``fit(execution_plan="fused")`` steps of
the configuration of ``tests/test_torch_resnet_train.py`` (64x64, 10
classes, B=4, f32, NHWC, ``Nesterovs(1e-7, 0.9)``, the same parameters,
state and Nesterovs state), the port's 16 blocks through the plain
versions of the forward and backward kernels, the JAX package's through
its Pallas kernels in interpret mode; the stem unfused in both. Scores,
parameters, BN state and the velocity within that file's limits (and
its reasons for them). A file of its own: the JAX interpret-mode train
step takes about half a minute to compile.
"""

import pytest

from test_torch_resnet_train import JAX_LIMIT, check, train_both
from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs():
    return train_both(("fused",), ("fused",))


def test_fused_plan_trains_as_the_jax_fused_graph(runs):
    check(runs, "port_fused", "jax_fused", JAX_LIMIT)
    assert runs["port_fused"][1]["score"] < runs["port_fused"][0]["score"]
