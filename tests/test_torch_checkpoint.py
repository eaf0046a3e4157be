"""The port's checkpoints (``repro_torch.checkpoint``, ``FLTrainer.save`` /
``restore``) against the JAX reference's, on the CPU at golden scale
(mnist_2nn, n = 8, kout k_out = 2).

Files cross both ways: what one package writes the other restores, every
array bit for bit (bf16 compared as its 16-bit patterns).  Random streams
do not cross: the restoring side passes its own generators (the port) or
keeps the well-formed key words the port writes under the reference's
names (the reference).  After a cross restore, one round on the
reference's draws (``_torch_parity.reference_draws``) must equal the
reference's round to the draw-exact 1e-5 of the round-parity tests.

The reference cannot take a bfloat16 file back, its own included:
``restore_bank`` returns the members as 2-byte void records, which
``jnp.asarray`` refuses in ``restore_state``, and with a spec its
``__base__`` check fails to cast them.  Its side of the bf16 test reads
the file with ``restore_bank`` and no spec and compares the bits (ROADMAP
queue 3).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    K_OUT,
    N_CLIENTS,
    golden_data,
    reference_draws,
    scenario_state_dump,
)
from repro import checkpoint as ref_ckpt
from repro.checkpoint import io as ref_io
from repro.core import ChurnModel as RefChurn
from repro.core import FLTrainer as RefTrainer
from repro.core import LinkModel as RefLink
from repro.core import TopologyConfig as RefTopo
from repro.core import make_algo as ref_make_algo
from repro.core.flat import make_spec as ref_make_spec
from repro.models.small import mnist_2nn as ref_mnist_2nn
from repro_torch import checkpoint
from repro_torch.checkpoint import io as port_io
from repro_torch.core import ChurnModel, FLTrainer, LinkModel, TopologyConfig
from repro_torch.core import make_algo
from repro_torch.core.flat import make_spec
from repro_torch.interop import program_with_delta_base
from repro_torch.models.small import mnist_2nn
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)

TOL = 1e-5  # draw-exact round parity, as tests/test_torch_round_*.py
ALGO_KW = dict(local_steps=2, batch_size=32)
SCENARIO = dict(algo=dict(compressor="topk_ef", topk_ratio=0.05),
                link=dict(drop=0.2, delay=2),
                churn=dict(fail_prob=0.2, recover_prob=0.5,
                           resurrect="cold"))

_DATA: dict = {}


def _data():
    if "c" not in _DATA:
        _DATA["c"] = golden_data()
    return _DATA["c"]


def _bits(a) -> np.ndarray:
    """An array's exact bits: bf16 (a tensor, an ml_dtypes array or the
    2-byte void records of a file) as uint16, anything else as itself."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return np.ascontiguousarray(a).view(np.uint16)
    return a


def _equal(a, b, what):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _pair(algo=None, link=None, churn=None, delta=None, bf16=False,
          seed=0):
    """(reference trainer, port trainer) of one composition; the port's
    delta bank trains over the reference's base."""
    kw = dict(ALGO_KW, **(algo or {}))
    data = _data()
    rm = ref_mnist_2nn()
    ref = RefTrainer(
        rm.loss, rm.init, {k: jnp.asarray(v) for k, v in data.items()},
        ref_make_algo("dfedsgpsm", **kw),
        RefTopo(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT), seed=seed,
        gossip="sparse", link=None if link is None else RefLink(**link),
        churn=None if churn is None else RefChurn(**churn), delta=delta,
        bank_dtype=jnp.bfloat16 if bf16 else None)
    m = mnist_2nn()
    port = FLTrainer(
        m.loss, m.init, data, make_algo("dfedsgpsm", **kw),
        TopologyConfig(kind="kout", n_clients=N_CLIENTS, k_out=K_OUT),
        seed=seed, gossip="sparse",
        link=None if link is None else LinkModel(**link),
        churn=None if churn is None else ChurnModel(**churn), delta=delta,
        bank_dtype=torch.bfloat16 if bf16 else None, device="cpu")
    if delta is not None:
        port.program = program_with_delta_base(
            port.program, jax.device_get(ref.program.spec.base))
        port.spec = port.program.spec
    return ref, port


def _streams(port):
    st = port.state
    return dict(key=torch.Generator().manual_seed(11),
                link_key=None if st.link == () else
                torch.Generator().manual_seed(12),
                churn_key=None if st.churn == () else
                torch.Generator().manual_seed(13))


def _ref_arrays(path) -> dict:
    """Every array of a file as the reference's reader returns it."""
    bank, extra, _ = ref_ckpt.restore_bank(path)
    return {"params": bank, **extra}


def _port_arrays(st) -> dict:
    out = {"params": st.params, "w": st.w, "losses": st.losses}
    if st.mom is not None:
        out["mom"] = st.mom
    if st.comp != ():
        out["comp"] = st.comp
    if st.link != ():
        for f in ("bufx", "bufw", "last"):
            if getattr(st.link, f) != ():
                out[f"link_{f}"] = getattr(st.link, f)
    if st.churn != ():
        out["churn_live"] = st.churn.live
        if st.churn.tpl != ():
            out["churn_tpl"] = st.churn.tpl
    return out


def _round_parity(ref, port):
    """One round of each on the reference's draws; states within TOL."""
    draws = reference_draws(ref, _data()["x"].shape[1])
    ref.run_round()
    port.run_round(draws)
    want, got = scenario_state_dump(ref), _port_arrays(port.state)
    for k in ("params", "w", "mom"):
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32)
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g - w).max()) <= TOL * scale, k


# -- flat banks --------------------------------------------------------------

def test_plain_bank_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"layer": {"w": np.ones((2, 3), np.float32),
                      "b": np.zeros((3,), np.float32)}}
    bank = rng.standard_normal((5, 9)).astype(np.float32)
    w = np.linspace(0.5, 1.5, 5).astype(np.float32)
    ref_spec = ref_make_spec(jax.tree.map(jnp.asarray, tree))
    spec = make_spec(jax.tree.map(torch.from_numpy, tree))
    assert port_io._spec_meta(spec) == ref_io._spec_meta(ref_spec)
    p = ref_ckpt.save_bank(str(tmp_path / "ref"), 1, jnp.asarray(bank),
                           ref_spec, extra={"w": jnp.asarray(w)})
    got, extra, meta = checkpoint.restore_bank(p, spec=spec)
    _equal(got, bank, "bank")
    _equal(extra["w"], w, "w")
    p = checkpoint.save_bank(str(tmp_path / "port"), 1,
                             torch.from_numpy(bank), spec,
                             extra={"w": torch.from_numpy(w)})
    got, extra, _ = ref_ckpt.restore_bank(p, spec=ref_spec)
    _equal(got, bank, "bank")
    _equal(extra["w"], w, "w")


def test_bf16_delta_bank_v3_crosses_both_ways(tmp_path):
    ref, port = _pair(delta=8, bf16=True)
    ref.run_round()
    path = ref_ckpt.save_state(str(tmp_path / "ref"), 1, ref.state,
                               ref.spec)
    with np.load(path) as f:
        assert "__base__" in f.files
    st = port.restore(path, **_streams(port))
    assert st.params.dtype == torch.bfloat16
    dump = jax.device_get(ref.state)
    _equal(st.params, np.asarray(dump.params), "params")
    _equal(st.mom, np.asarray(dump.mom), "mom")
    _equal(st.w, np.asarray(dump.w), "w")
    assert st.round == 1

    port.run_round()
    path = port.save(str(tmp_path / "port"), 2)
    bank, extra, meta = ref_ckpt.restore_bank(path)
    assert meta["format"] == 3 and meta["dtype"] == "bfloat16"
    assert meta["delta"] == ref_io._spec_meta(ref.spec)["delta"]
    _equal(bank, port.state.params, "params")
    _equal(extra["mom"], port.state.mom, "mom")
    _equal(extra["w"], port.state.w, "w")
    with np.load(path) as f:
        _equal(f["__base__"], port.spec.base_row(), "__base__")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_full_state_crosses_and_the_next_round_matches(tmp_path, writer):
    """A state with the EF residual, the two-round link buffers and the cold
    churn carry: restored bit for bit, then one round on the reference's
    draws equal to the reference's."""
    ref, port = _pair(**SCENARIO)
    if writer == "reference":
        ref.run_round()
        path = ref.save(str(tmp_path), 1)
        st = port.restore(path, **_streams(port))
    else:
        port.run_round()
        path = port.save(str(tmp_path), 1)
        ref.restore(path)
        st = port.state
    want = _ref_arrays(path)
    got = _port_arrays(st)
    assert set(got) == {k for k in want if k in got} | set(got)
    for k, v in got.items():
        _equal(v, want[k], k)
    dump = scenario_state_dump(ref)
    _equal(st.params, dump["params"], "reference params")
    _equal(st.comp, dump["comp"], "reference comp")
    _equal(st.link.bufx, dump["link"]["bufx"], "reference link bufx")
    _equal(st.churn.live, dump["churn"]["live"], "reference liveness")
    assert int(np.asarray(ref.state.round)) == st.round == 1
    _round_parity(ref, port)


def test_port_streams_restore_exactly(tmp_path):
    _, port = _pair(**SCENARIO)
    port.run_round()
    path = port.save(str(tmp_path), 1)
    _, other = _pair(**SCENARIO, seed=7)
    st = other.restore(path)
    for a, b in ((port.state.key, st.key), (port.state.link.key, st.link.key),
                 (port.state.churn.key, st.churn.key)):
        assert torch.equal(a.get_state(), b.get_state())
        assert a.initial_seed() == b.initial_seed()
    port.run_round()
    other.run_round()
    for k in ("params", "mom", "w", "comp"):
        assert torch.equal(getattr(port.state, k), getattr(other.state, k)), k


def test_a_jax_key_is_never_taken_for_a_stream(tmp_path):
    ref, port = _pair(**SCENARIO)
    path = ref.save(str(tmp_path), 0)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        port.restore(path)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        checkpoint.restore_state(path, port.spec,
                                 key=torch.Generator(),
                                 link_key=torch.Generator())


# -- pytrees, retention, legacy formats --------------------------------------

def test_pytree_retention_and_latest(tmp_path):
    tree = {"layer": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "step": torch.tensor(7, dtype=torch.int32)}
    for step in range(5):
        checkpoint.save(str(tmp_path), step, tree, keep=2)
    latest = checkpoint.latest_checkpoint(str(tmp_path))
    assert latest.endswith("ckpt_4.npz")
    assert latest == ref_ckpt.latest_checkpoint(str(tmp_path))
    kept = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert kept == ["ckpt_3.npz", "ckpt_4.npz"]
    got = checkpoint.restore(latest, like=tree)
    assert torch.equal(got["layer"]["w"], tree["layer"]["w"])
    assert got["step"].dtype == torch.int32
    ref_tree = {"layer": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
                "step": jnp.int32(7)}
    back = ref_ckpt.restore(latest, like=ref_tree)
    _equal(np.asarray(back["layer"]["w"]), tree["layer"]["w"], "w")
    ref_path = ref_ckpt.save(str(tmp_path / "ref"), 0, ref_tree)
    got = checkpoint.restore(ref_path, like=tree)
    assert torch.equal(got["layer"]["w"], tree["layer"]["w"])
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore(ref_path, like={"b": torch.zeros(3)})
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_v2_row_chunks_from_the_reference(tmp_path):
    tree = {"layer": {"w": jnp.ones((2, 3)), "b": jnp.zeros((3,))}}
    ref_spec = ref_make_spec(tree)
    spec = make_spec(jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)),
                                  tree))
    n = 1000
    bank = jax.random.normal(jax.random.PRNGKey(0), (n, ref_spec.dim))
    mom = jax.random.normal(jax.random.PRNGKey(1), (n, ref_spec.dim))
    w = jnp.linspace(0.5, 1.5, n)
    path = ref_ckpt.save_bank(
        str(tmp_path), 3, bank, ref_spec,
        extra={"mom": mom, "w": w, "round": jnp.int32(3)}, chunk_rows=128)
    got, extra, meta = checkpoint.restore_bank(path, spec=spec)
    assert meta["format"] == 2 and meta["bank_chunks"] == 8
    _equal(got, np.asarray(bank), "bank")
    _equal(extra["mom"], np.asarray(mom), "mom")
    _equal(extra["w"], np.asarray(w), "w")
    assert int(extra["round"]) == 3
    path = checkpoint.save_bank(
        str(tmp_path / "port"), 3, torch.from_numpy(np.asarray(bank)), spec,
        extra={"mom": torch.from_numpy(np.asarray(mom))}, chunk_rows=128)
    with np.load(path) as f:
        assert "extra_mom_c00007" in f.files and "__bank_c00007__" in f.files
    got, extra, _ = ref_ckpt.restore_bank(path, spec=ref_spec)
    _equal(got, np.asarray(bank), "bank")
    _equal(extra["mom"], np.asarray(mom), "mom")


def test_v1_monolithic_bank_loads(tmp_path):
    spec = make_spec({"a": torch.zeros((3,))})
    ref_spec = ref_make_spec({"a": jnp.zeros((3,))})
    bank = np.arange(12, dtype=np.float32).reshape(4, 3)
    p = str(tmp_path / "ckpt_0.npz")
    np.savez(p, __bank__=bank,
             __bank_meta__=np.array(json.dumps(ref_io._spec_meta(ref_spec))),
             extra_w=np.full((4,), 1.25, np.float32))
    got, extra, meta = checkpoint.restore_bank(p, spec=spec)
    _equal(got, bank, "bank")
    _equal(extra["w"], np.full((4,), 1.25, np.float32), "w")
    assert meta.get("format", 1) != 2


def test_bank_layout_and_base_mismatches_raise(tmp_path):
    ref, port = _pair(delta=8)
    path = port.save(str(tmp_path), 0)
    dense = make_spec(mnist_2nn().init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore_bank(path, spec=dense)
    from repro_torch.core.flat import bind_delta_spec, tree_map

    drifted = bind_delta_spec(port.spec.delta,
                              tree_map(lambda x: x + 0.5, port.spec.base))
    with pytest.raises(ValueError, match="base"):
        checkpoint.restore_bank(path, spec=drifted)
    with pytest.raises(ValueError, match="base"):
        ref_ckpt.restore_bank(path, spec=ref.spec.__class__(
            ref.spec.delta, jax.tree.map(lambda x: x + 0.5, ref.spec.base)))


# -- FLTrainer.restore's composition guards ------------------------------------

_GUARDS = {
    "comp absent": (dict(), dict(algo=dict(compressor="topk_ef")),
                    "no compressor state"),
    "comp present": (dict(algo=dict(compressor="topk_ef")), dict(),
                     "stateless"),
    "link absent": (dict(), dict(link=dict(drop=0.2, delay=2)),
                    "unreliable-link"),
    "link present": (dict(link=dict(drop=0.2, delay=2)), dict(),
                     "unreliable-link"),
    "link delay bound": (dict(link=dict(delay=2)), dict(link=dict(delay=1)),
                         "link carry field 'bufx'"),
    "link event vs delay": (dict(link=dict(delay=1)),
                            dict(link=dict(event_threshold=0.5)),
                            "link carry field"),
    "churn absent": (dict(), dict(churn=dict(fail_prob=0.2)),
                     "node-churn"),
    "churn present": (dict(churn=dict(fail_prob=0.2)), dict(),
                      "node-churn"),
    "churn template": (dict(churn=dict(fail_prob=0.2)),
                       dict(churn=dict(fail_prob=0.2, resurrect="cold")),
                       "cold-resurrection template"),
}


@pytest.mark.parametrize("case", list(_GUARDS))
def test_restore_guards_raise_where_the_reference_does(tmp_path, case):
    saved, restoring, match = _GUARDS[case]
    _, port_src = _pair(**saved)
    ref_src, _ = _pair(**saved)
    ref_dst, port_dst = _pair(**restoring)
    p_port = port_src.save(str(tmp_path / "port"), 0)
    p_ref = ref_src.save(str(tmp_path / "ref"), 0)
    for path in (p_port, p_ref):
        with pytest.raises(ValueError, match=match):
            ref_dst.restore(path)
        with pytest.raises(ValueError, match=match):
            port_dst.restore(path, **_streams(port_dst))
