"""Round parity of the port's compressors and proximal solver against the
JAX reference on the golden setting (mnist_2nn, n = 8, kout k_out = 2,
3 local steps, 3 rounds), each round on the reference's own draws (see
``_torch_parity``).

Draw-exact compositions (the proximal solver at alpha = 0 and 0.9) keep
the round-parity tolerances of ``test_torch_round_dense.py``: the bank
within 1e-5 of its largest magnitude, ``w`` within 1e-6, loss and
accuracy within 1e-5, and the momentum bank within 1e-5 of its own.

The lossy compressors amplify the ~1e-7 relative noise between the two
packages' banks: a coordinate whose quotient ``x / scale`` lies within
the noise of a half-integer rounds to neighbouring int8 codes, and a
coordinate whose magnitude is within the noise of the k-th largest is
kept by one package and dropped by the other.  So these runs restart the
port from the reference's state before every round (each comparison holds
one round's divergence) and hold receiver i's row of the mixed bank to

    1e-5 max|X| + sum_{j != i} P[i, j] step_j

where ``step_j`` is what one flip can move sender j's transmitted
coordinate by: one quantisation step ``max|x_j| / 127`` (int8), or the
k-th largest magnitude of ``x_j + residual_j`` (top-k, a kept coordinate
against a dropped one).  The self-loop rides at full precision, so a
receiver's own flips do not count.  ``step_j`` is read from the port's
own pre-compression bank (its local steps run again on the same draws).
The EF residual differs where a coordinate was swapped by at most that
sender's k-th magnitude.  Each test prints the coordinates beyond the
draw-exact tolerance (int8: every output a flipped code reaches) and the
swapped top-k coordinates (where exactly one package's residual is 0).

bf16 banks: each package rounds its f32 local updates and mixes to bf16,
and a value within the noise of a rounding boundary lands one bf16 ulp
apart (at most 2^-7 of the bank's largest magnitude).  The bank is held
to ``2^-7 max|X| + sum_{j != i} P[i, j] kth_j``, the momentum bank (fed
the bf16-rounded gradients) to one bf16 ulp of its largest magnitude,
``2^-7 max|V|``, and the residual to ``2^-7 max|y| + max_j kth_j``.
"""
import numpy as np
import pytest

from _torch_parity import (
    PreCompression,
    flip_bound,
    flip_step,
    golden_data,
    run_scenario_parity,
)
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)


@pytest.fixture(scope="module")
def cdata():
    return golden_data()


@pytest.mark.parametrize("gossip", ["dense", "sparse"])
@pytest.mark.parametrize("compressor", ["int8_rows", "topk_ef"])
def test_lossy_compressor_round_parity(cdata, compressor, gossip):
    probe = PreCompression()
    for r, ref_m, port_m, ref_s, port_s in run_scenario_parity(
            "dfedsgpsm", gossip, cdata, algo_kw=dict(compressor=compressor),
            resync=True, probe=probe):
        rec = probe.rounds[r]
        step = flip_step(rec, compressor)
        want, got = ref_s["params"], port_s["params"]
        scale = float(np.abs(want).max())
        err = np.abs(got - want)
        bound = 1e-5 * scale + flip_bound(rec["P"], step)
        assert np.all(err <= bound), (r, float((err - bound).max()))
        off = int((err > 1e-5 * scale).sum())
        msg = f"{compressor} {gossip} round {r}: {off} coordinates of X' " \
              f"beyond 1e-5 max|X|, at most {float((err / bound).max()):.3f}" \
              " of the flip bound"
        if compressor == "topk_ef":
            swapped = int(((ref_s["comp"] == 0) != (port_s["comp"] == 0)).sum())
            msg += f", {swapped} top-k coordinates swapped"
            np.testing.assert_allclose(port_s["comp"], ref_s["comp"], rtol=0,
                                       atol=1e-5 * scale + float(step.max()))
        print(msg)
        np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0, atol=1e-6)
        mom = ref_s["mom"]
        np.testing.assert_allclose(port_s["mom"], mom, rtol=0,
                                   atol=1e-5 * float(np.abs(mom).max()))
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (k, r, port_m, ref_m)


@pytest.mark.parametrize("name,gossip", [("osgp", "dense"),
                                         ("dfedsgpsm", "sparse")])
def test_proximal_solver_round_parity(cdata, name, gossip):
    """osgp runs at alpha = 0 (the zero-momentum fast path), dfedsgpsm at
    alpha = 0.9; mu = 0.05 so the pull moves the bank by more than the
    tolerance."""
    for r, ref_m, port_m, ref_s, port_s in run_scenario_parity(
            name, gossip, cdata, algo_kw=dict(solver="proximal",
                                              prox_mu=0.05)):
        scale = float(np.abs(ref_s["params"]).max())
        np.testing.assert_allclose(port_s["params"], ref_s["params"], rtol=0,
                                   atol=1e-5 * scale, err_msg=f"round {r}")
        np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0, atol=1e-6)
        mom = ref_s["mom"]
        np.testing.assert_allclose(port_s["mom"], mom, rtol=0,
                                   atol=1e-5 * max(float(np.abs(mom).max()),
                                                   1e-30))
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (k, r, port_m, ref_m)


def test_bf16_bank_with_topk_round_parity(cdata):
    probe = PreCompression()
    for r, ref_m, port_m, ref_s, port_s in run_scenario_parity(
            "dfedsgpsm", "dense", cdata, algo_kw=dict(compressor="topk_ef"),
            bf16=True, resync=True, probe=probe):
        rec = probe.rounds[r]
        kth = flip_step(rec, "topk_ef")
        want = ref_s["params"].astype(np.float32)
        scale = float(np.abs(want).max())
        err = np.abs(port_s["params"] - want)
        bound = 2.0 ** -7 * scale + flip_bound(rec["P"], kth)
        assert np.all(err <= bound), (r, float((err - bound).max()))
        print(f"bf16 topk_ef round {r}: {int((err > 0).sum())} of {err.size} "
              "bank values differ, at most "
              f"{float(err.max()) / (2.0 ** -7 * scale):.3f} of 2^-7 max|X|")
        ymax = float(rec["y"].abs().max())
        np.testing.assert_allclose(
            port_s["comp"], ref_s["comp"], rtol=0,
            atol=2.0 ** -7 * ymax + float(kth.max()))
        mom = ref_s["mom"]
        np.testing.assert_allclose(port_s["mom"], mom, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(mom).max()))
        np.testing.assert_allclose(port_s["w"], ref_s["w"], rtol=0, atol=1e-6)
        for k in ("loss", "acc"):
            assert abs(port_m[k] - ref_m[k]) <= 1e-5, (k, r, port_m, ref_m)
