"""Round parity of the port's churn scenarios and delta bank against the JAX
reference on the golden setting (mnist_2nn, n = 8, kout k_out = 2, 3 local
steps, 3 rounds), each round on the reference's own draws — the operator,
the minibatches, the churn stream's three uniforms and, with links, the
drop uniforms and delays (see ``_torch_parity``).

These compositions are draw-exact (the churn transition and masks are bit
for bit the reference's, ``test_torch_scenario_builds.py``): the liveness
vector and the cold template must be equal, the bank, the in-flight
payload and the momentum bank within 1e-5 of their largest magnitudes,
``w`` and ``bufw`` within 1e-6, and loss, accuracy, ``live_frac``,
``dead_mass``, ``w_mass`` and ``w_inflight`` within 1e-5.  With drops 0.2
and delays 2 the reference's loss grows over long runs (ROADMAP, North
star), so nothing here asks it to fall.

The delta bank trains over the reference's frozen base
(``interop.program_with_delta_base``).  Its rows are deltas, whose
magnitude is far below the base's; the bank is held to 1e-5 of its own
largest magnitude all the same.
"""
import numpy as np
import pytest

from _torch_parity import golden_data, run_scenario_parity
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

WARM = dict(fail_prob=0.3, recover_prob=0.5)
COLD = dict(fail_prob=0.3, recover_prob=0.5, permanent_frac=0.2,
            resurrect="cold")


@pytest.fixture(scope="module")
def cdata():
    return golden_data()


def _check(r, ref_m, port_m, ref_s, port_s):
    scale = float(np.abs(ref_s["params"]).max())
    np.testing.assert_allclose(port_s["params"], ref_s["params"], rtol=0,
                               atol=1e-5 * scale, err_msg=f"round {r}")
    np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0, atol=1e-6)
    mom = ref_s["mom"]
    np.testing.assert_allclose(port_s["mom"], mom, rtol=0,
                               atol=1e-5 * float(np.abs(mom).max()))
    np.testing.assert_allclose(port_s["losses"], ref_s["losses"], rtol=0,
                               atol=1e-5)
    if "link" in ref_s:
        for k, tol in (("bufx", 1e-5 * scale), ("bufw", 1e-6)):
            np.testing.assert_allclose(port_s["link"][k], ref_s["link"][k],
                                       rtol=0, atol=tol, err_msg=k)
    assert set(port_m) == set(ref_m), (port_m, ref_m)
    for k, v in ref_m.items():
        assert abs(port_m[k] - v) <= 1e-5, (k, r, port_m, ref_m)


@pytest.mark.parametrize("churn,link,gossip", [
    (WARM, None, "dense"),
    (COLD, None, "sparse"),
    (WARM, dict(drop=0.2, delay=2), "dense"),
    (COLD, dict(drop=0.2, delay=2), "sparse"),
], ids=["warm-dense", "cold-sparse", "warm-drop-delay-dense",
        "cold-drop-delay-sparse"])
def test_churn_round_parity(cdata, churn, link, gossip):
    cold = churn.get("resurrect") == "cold"
    live = np.ones(8, np.int8)
    went_down = reborn = False
    for out in run_scenario_parity("dfedsgpsm", gossip, cdata, churn=churn,
                                   link=link):
        _check(*out)
        r, ref_m, _, ref_s, port_s = out
        np.testing.assert_array_equal(port_s["churn"]["live"],
                                      ref_s["churn"]["live"])
        if cold:
            np.testing.assert_array_equal(port_s["churn"]["tpl"],
                                          ref_s["churn"]["tpl"])
        else:
            assert port_s["churn"]["tpl"] is None
        assert abs(ref_m["w_mass"] - 8.0) <= 1e-5
        now = port_s["churn"]["live"]
        went_down |= bool(np.any(now != 1))
        reborn |= bool(np.any((live == 0) & (now == 1)))
        live = now
    assert went_down and reborn, "the run must fail and revive a client"


@pytest.mark.parametrize("rank,gossip", [(8, "dense"), ("full", "sparse")])
def test_delta_bank_round_parity(cdata, rank, gossip):
    for out in run_scenario_parity("dfedsgpsm", gossip, cdata, delta=rank):
        _check(*out)
