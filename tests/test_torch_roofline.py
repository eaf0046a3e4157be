"""The counting mode (``repro_torch.roofline.cost.CostMode``) on small CPU
tensors, each kernel's cost formula against a hand count, the flash
wrapper's meta branch and record, and a meta trace against a CPU run of the
same reduced step (the reference's XLA cost analysis has no counterpart to
hold these to).  Exact unless stated."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from _torch_dryrun_ref import one_thread  # noqa: F401  (autouse fixture)
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import gossip_gather as gg
from repro_torch.kernels import gossip_matmul as gm
from repro_torch.launch import dryrun
from repro_torch.models.registry import get_model_api
from repro_torch.roofline import cost
from repro_torch.roofline.cost import CostMode


def _count(fn, *args):
    with CostMode(args) as mode:
        out = fn(*args)
    return mode.result(out)


def test_a_matmul_counts_its_flops_and_operands():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    r = _count(torch.matmul, a, b)
    assert r["aten_flops"] == 2 * 8 * 16 * 4
    assert r["aten_bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_an_elementwise_op_reads_its_inputs_and_writes_its_output():
    x, y = torch.randn(100), torch.randn(100)
    r = _count(torch.add, x, y)
    assert r["aten_flops"] == 0 and r["aten_bytes"] == 3 * 4 * 100
    r = _count(lambda t: t * t, x)  # one input read once
    assert r["aten_bytes"] == 2 * 4 * 100


def test_views_count_nothing():
    x = torch.randn(6, 8)
    r = _count(lambda t: (t.view(8, 6), t.t(), t[2:5], t.unsqueeze(0),
                          t.transpose(0, 1)), x)
    assert r["aten_bytes"] == 0 and r["aten_flops"] == 0
    assert r["memory"]["temp"] == 0


def test_embedding_counts_the_rows_it_reads():
    table = torch.randn(1000, 32)
    idx = torch.tensor([3, 5, 7, 11, 13])
    r = _count(torch.nn.functional.embedding, idx, table)
    # 5 rows read and written, the int64 indices read
    assert r["aten_bytes"] == 2 * 5 * 32 * 4 + 5 * 8


def test_a_cache_slot_write_counts_its_slot():
    cache = torch.zeros(2, 64, 8)
    x = torch.randn(2, 8)

    def write(c, v):
        c[:, 10].copy_(v)

    assert _count(write, cache, x)["aten_bytes"] == 2 * 2 * 8 * 4
    rows, cols = torch.arange(2)[:, None], torch.tensor([[1, 4, 9]])
    vals = torch.randn(2, 3, 8)
    r = _count(lambda c, i, j, v: c.index_put_((i, j), v), cache, rows, cols,
               vals)
    # the 48 values read and written into their slots, the indices read
    assert r["aten_bytes"] == 2 * 48 * 4 + (2 + 3) * 8


def test_the_peak_follows_the_storages_the_step_allocates():
    arg = torch.zeros(250)

    def step(a):
        x = torch.empty(1000)  # 4000 bytes
        y = torch.empty(2000)  # 8000: 12000 live
        del x
        z = torch.empty(500)  # 10000 live
        return y, z, a.view(5, 50)

    r = _count(step, arg)
    mem = r["memory"]
    assert mem["argument"] == 1000 and mem["temp"] == 12000
    assert mem["output"] == 10000 and mem["alias"] == 1000
    assert mem["peak_estimate"] == 13000


def test_open_pairs_counts_the_masks_open_pairs():
    for s in (1, 2, 5, 17, 64):
        for causal in (True, False):
            for window in (0, 1, 3, 16, 64, 100):
                ok = 0
                for q in range(s):
                    for k in range(s):
                        open_ = (k <= q or not causal) and (
                            not window or q - k < window)
                        ok += open_
                assert cost.open_pairs(s, causal, window) == ok, (s, causal,
                                                                   window)


def test_kernel_formulas_against_a_hand_count():
    # flash forward: q, k, v, o in bf16; 4 hd FLOP a pair a query head
    b, h, kv, s, hd = 2, 8, 2, 10, 64
    f = cost.flash_forward_cost(b, h, kv, s, hd, True, 0, 2)
    assert f == (4 * hd * b * h * 55, 2 * (b * h * s * hd * 2
                                           + b * kv * s * hd * 2))
    f = cost.flash_forward_cost(b, h, kv, s, hd, True, 0, 2, lse=True)
    assert f.bytes == 2 * (2 * b * h + 2 * b * kv) * s * hd + 4 * b * h * s
    # backward: q, o, dO, dq and k, v, dk, dv; the lse read
    f = cost.flash_backward_cost(b, h, kv, s, hd, False, 3, 4, lse=True)
    pairs = s * s - (s - 3) * (s - 2) // 2
    assert f == (10 * hd * b * h * pairs,
                 4 * (4 * b * h + 4 * b * kv) * s * hd + 4 * b * h * s)
    # dense mix (m, n) x (n, D): P f32, X read, Y written
    assert cost.dense_mix_cost(3, 5, 7, 2) == (2 * 3 * 5 * 7,
                                               4 * 15 + 2 * (5 + 3) * 7)
    # gather: m receivers of k slots over n rows
    assert cost.gather_cost(4, 9, 3, 11, 4) == (2 * 4 * 3 * 11,
                                                4 * (9 + 4) * 11 + 8 * 4 * 3)
    # bank update: X, G, X', Z' in the bank's dtype, V and V' in f32, w
    assert cost.update_cost(6, 10, 2) == (5 * 60, (4 * 2 + 8) * 60 + 4 * 6)
    assert cost.update_cost(6, 10, 4) == (5 * 60, 24 * 60 + 4 * 6)


def test_bound_ms_takes_the_larger_time():
    assert cost.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert cost.bound_ms(0, 67e9) == (1.0, "operations")
    assert cost.bound_ms(0, 989e9, 989e12)[1] == "operations"


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_meta_branch_records_its_formula(causal, window):
    b, h, kv, s, hd = 2, 8, 2, 24, 64
    q = torch.empty(b, h, s, hd, dtype=torch.bfloat16, device="meta")
    k, v = (torch.empty(b, kv, s, hd, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    r = _count(lambda *a: fa.flash_attention(*a, causal=causal,
                                             window=window), q, k, v)
    rec = r["kernels"]["flash_attention"]
    assert rec["launches"] == 1
    assert rec["flops"] == 4 * hd * b * h * cost.open_pairs(s, causal, window)
    assert r["aten_bytes"] == 0 and r["aten_flops"] == 0
    assert r["memory"]["temp"] == b * h * s * hd * 2  # the output


def test_flash_backward_meta_branch_allocates_the_kernels_scratch():
    b, h, kv, s, hd = 1, 8, 2, 100, 128
    q, o, do = (torch.empty(b, h, s, hd, dtype=torch.bfloat16,
                            device="meta") for _ in range(3))
    k, v = (torch.empty(b, kv, s, hd, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    lse = torch.empty(b, h, s, device="meta")
    r = _count(lambda *a: fa.flash_attention_backward(*a, True, 0, lse=lse),
               q, k, v, o, do)
    rec = r["kernels"]["flash_attention_backward"]
    assert rec["flops"] == 10 * hd * b * h * s * (s + 1) // 2
    shares = fa.backward_shares(torch.bfloat16, hd, b, h, kv, s)
    assert shares == 4  # 2 (b, kv) blocks: the group's 4 heads one a run
    grads = 2 * (b * h + 2 * b * kv) * s * hd
    scratch = 4 * 2 * b * h * 128 + 2 * 4 * b * kv * shares * s * hd
    assert r["memory"]["temp"] == grads + scratch


def test_fl_wrappers_record_their_formulas():
    n, d = 4, 10
    X, G = torch.randn(n, d), torch.randn(n, d)
    V, w = torch.randn(n, d), torch.rand(n) + 0.5
    P = torch.rand(n, n)
    idx = torch.randint(0, n, (n, 3), dtype=torch.int32)
    wgt = torch.rand(n, 3)
    with CostMode() as mode:
        fu.fused_update_bank(X, V, G, 0.9, 0.1, w)
        gm.gossip_matmul(P, X)
        gg.gossip_gather(idx, wgt, X)
    r = mode.result()
    assert r["aten_bytes"] == 0 and r["aten_flops"] == 0
    assert r["kernels"] == {
        "fused_update_bank": {"launches": 1,
                              **dict(zip(("flops", "bytes"),
                                         cost.update_cost(n, d, 4)))},
        "gossip_gather": {"launches": 1,
                          **dict(zip(("flops", "bytes"),
                                     cost.gather_cost(n, n, 3, d, 4)))},
        "gossip_matmul": {"launches": 1,
                          **dict(zip(("flops", "bytes"),
                                     cost.dense_mix_cost(n, n, d, 4)))},
    }


def test_a_pod_bank_above_2_31_columns_counts_every_column():
    """gemma3-12b cut to one 5:1 period (phase 20's pod round, 6 of 48
    layers) has more than 2^31 parameters a replica: its (2, D) pod bank is
    the first above 2^31 columns.  The mix's and the update's meta branches
    give outputs of the bank's shape, and their records count every column
    (Python integers: nothing wraps at 32 bits)."""
    cfg = dataclasses.replace(get_config("gemma3-12b"), n_layers=6)
    d = get_model_api(cfg).num_params()
    assert d > 2 ** 31
    P = torch.empty(2, 2, device="meta")
    X, V, G = (torch.empty(2, d, device="meta") for _ in range(3))
    w = torch.empty(2, device="meta")
    with CostMode() as mode:
        Y = gm.gossip_matmul(P, X)
        out = fu.fused_update_bank(X, V, G, 0.9, 0.1, w)
    assert Y.shape == (2, d) and all(t.shape == (2, d) for t in out)
    r = mode.result()["kernels"]
    assert r["gossip_matmul"]["flops"] == 2 * 2 * 2 * d
    assert r["gossip_matmul"]["bytes"] == 4 * 2 * 2 + 4 * 4 * d
    assert r["fused_update_bank"]["flops"] == 5 * 2 * d
    assert r["fused_update_bank"]["bytes"] == 24 * 2 * d + 4 * 2


STEPS = [("glm4-9b", "train_step", ("t", 32, 1, "train")),
         ("glm4-9b", "round_step", ("t", 32, 2, "train")),
         ("glm4-9b", "serve_step", ("d", 32, 2, "decode")),
         ("hubert-xlarge", "forward", ("p", 40, 2, "prefill")),
         ("dbrx-132b", "forward", ("p", 32, 2, "prefill")),
         ("xlstm-350m", "serve_step", ("d", 16, 2, "decode"))]


@pytest.mark.parametrize("arch,step,shape", STEPS)
def test_a_meta_trace_counts_what_a_cpu_run_counts(arch, step, shape):
    """The same reduced step traced on meta (empty tensors) and run on the
    CPU (drawn values, the plain versions inside the kernel wrappers):
    equal aten FLOPs and bytes, equal kernel records."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    api = get_model_api(cfg)
    shape = InputShape(*shape)
    meta = dryrun.trace(api, shape, step)
    args, run = dryrun.step_args(api, shape, step, device="cpu", seed=0)
    with CostMode(args) as mode:
        out = run(*args)
    got = mode.result(out)
    assert got["aten_flops"] == meta["aten_flops"] > 0
    assert got["aten_bytes"] == meta["aten_bytes"] > 0
    assert got["aten_ops"] == meta["aten_ops"]
    assert got["kernels"] == meta["kernels"]
    assert got["memory"]["argument"] == meta["memory"]["argument"]
