"""Round parity of the PyTorch port against the JAX reference, sparse mix:
all 10 registry algorithms on the golden setting (mnist_2nn, n = 8, kout
k_out = 2, participation 0.25, 3 local steps, 3 rounds), the port started
from the reference's initial state and fed the reference's own draws each
round (see ``_torch_parity``).

Tolerances: both packages compute in float32 on the CPU and differ only in
the order of their reductions (matmul, conv and sum kernels of XLA and of
PyTorch), about 1e-7 relative per round here.  The bank must hold within
1e-5 of its largest magnitude after every round (50x that), the push-sum
weights within 1e-6 (a few ulp of 1), loss and accuracy within 1e-5.
"""
import numpy as np
import pytest

from _torch_parity import golden_data, run_parity
from repro.core import ALGORITHMS
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

GOSSIP = "sparse"


@pytest.fixture(scope="module")
def cdata():
    return golden_data()


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_round_parity_sparse(name, cdata):
    for r, ref_m, port_m, ref_s, port_s in run_parity(name, GOSSIP, cdata):
        scale = float(np.abs(ref_s["params"]).max())
        np.testing.assert_allclose(
            port_s["params"], ref_s["params"], rtol=0, atol=1e-5 * scale,
            err_msg=f"{name} bank, round {r}")
        np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0,
                                   atol=1e-6, err_msg=f"{name} w, round {r}")
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (name, k, r, port_m,
                                                       ref_m)
