"""Round parity of the port's unreliable-link scenarios against the JAX
reference on the golden setting (mnist_2nn, n = 8, kout k_out = 2, 3 local
steps, 3 rounds), each round on the reference's own draws — the operator,
the minibatches, and the link stream's drop uniforms and delays (see
``_torch_parity``).

These compositions are draw-exact: the drop and delay builds are bit for
bit the reference's (``test_torch_scenario_builds.py``), so the two
packages differ only in the order of their f32 reductions, about 1e-7
relative a round.  The bank, the in-flight payload ``bufx`` and the event
cache ``last`` hold within 1e-5 of the bank's largest magnitude after every
round, ``w`` and ``bufw`` within 1e-6, loss, accuracy, ``w_mass`` and
``w_inflight`` within 1e-5, ``comm_fraction`` exactly.

The event trigger compares ``sqrt(sum(drift^2))`` with the threshold, a
comparison the noise could flip where a norm lies at the threshold.  The
thresholds below were chosen so that every client's drift norm of every
round lies at least 1e-3 (relative) away from the round's threshold, and
the test asserts that margin on the port's norms, which agree with the
reference's to about 1e-6 relative (the bank's parity): a flip there
would be a defect.  Both thresholds leave some rounds with some clients
silent and some transmitting.
"""
import numpy as np
import pytest
import torch

from _torch_parity import golden_data, run_scenario_parity
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

MARGIN = 1e-3


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
    link = ref_s["link"]
    for k, tol in (("bufx", 1e-5 * scale), ("bufw", 1e-6),
                   ("last", 1e-5 * scale)):
        if link[k] is None:
            assert port_s["link"][k] is None, k
        else:
            np.testing.assert_allclose(port_s["link"][k], link[k], rtol=0,
                                       atol=tol, err_msg=f"{k}, round {r}")
    assert set(port_m) == set(ref_m), (port_m, ref_m)
    for k, v in ref_m.items():
        if k == "comm_fraction":
            assert port_m[k] == v, (r, port_m, ref_m)
        else:
            assert abs(port_m[k] - v) <= 1e-5, (k, r, port_m, ref_m)


@pytest.mark.parametrize("name,gossip", [
    ("dfedsgpsm", "dense"),
    ("dfedsgpsm", "sparse"),
    ("dfedavgm", "dense"),  # symmetric: one coin per undirected edge
])
def test_dropped_links_round_parity(cdata, name, gossip):
    for out in run_scenario_parity(name, gossip, cdata, link=dict(drop=0.3)):
        _check(*out)
        assert abs(out[2]["w_mass"] - 8.0) <= 1e-5


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
def test_delayed_links_round_parity(cdata, gossip):
    for out in run_scenario_parity("dfedsgpsm", gossip, cdata,
                                   link=dict(delay=2)):
        _check(*out)
        r, _, port_m, _, port_s = out
        assert port_s["link"]["bufx"].shape[0] == 2
        assert abs(port_m["w_mass"] - 8.0) <= 1e-5
        assert port_m["w_inflight"] > 0


class DriftMargin:
    """Probe: every client's drift norm this round, from the port's own
    local steps on the round's draws, must lie MARGIN away from the
    round's threshold; records the share above it."""

    def __init__(self, threshold, decay):
        self.threshold, self.decay = threshold, decay
        self.sent = []

    def __call__(self, port, draws):
        prog, st = port.program, port.state
        X, *_ = prog.solver.update(
            prog.loss_fn, prog.spec, st.params, st.w,
            torch.as_tensor(draws["batch_idx"]).long(), prog.data,
            prog.round_lr(st.round))
        norms = torch.sqrt(((X - st.link.last) ** 2).sum(dim=1)).numpy()
        thr = float(prog.mixer._threshold_at(st.round))
        np.testing.assert_allclose(thr, self.threshold * self.decay
                                   ** st.round, rtol=1e-6)
        gap = np.abs(norms / thr - 1.0)
        assert gap.min() >= MARGIN, (st.round, thr, norms)
        self.sent.append(float((norms > thr).mean()))


@pytest.mark.parametrize("threshold,decay", [(1.8, 1.0), (2.0, 0.9)])
def test_event_triggered_round_parity(cdata, threshold, decay):
    probe = DriftMargin(threshold, decay)
    link = dict(event_threshold=threshold, event_decay=decay)
    for out in run_scenario_parity("dfedsgpsm", "dense", cdata, link=link,
                                   probe=probe):
        _check(*out)
        r, _, port_m = out[:3]
        assert port_m["comm_fraction"] == probe.sent[r]
    assert any(0.0 < s < 1.0 for s in probe.sent), probe.sent
