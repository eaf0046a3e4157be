#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, through its
hand-written Hopper kernels: DFedSGPSM rounds on the flat bank, serving
gemma3-12b (prefill, then greedy decode), the FL round's scenarios
(compressors, proximal solver, link and churn scenarios, the bf16 delta
bank), checkpoints, the paged client store, personalized serving of
glm4-9b over the delta bank, pods-as-clients training of glm4-9b,
serving the MoE family (dbrx-132b, deepseek-v3-671b), serving the vlm
(llava-next-mistral-7b), running the masked_lm encoder (hubert-xlarge,
whose head dim 80 has its own flash instantiations, forward and
backward), serving and training the recurrent xlstm-350m and the hybrid
hymba-1.5b, training the masked_lm and vlm tasks (hubert-xlarge,
llava-next-mistral-7b) with the pods-as-clients round, personalized lanes
of every family beside the dense decoders, the two-tier topology family
and the row-sharded bank (the all-gather and halo executors over
``torch.distributed``, NCCL on the card), and the pod runtime (a replica
as DTensors over a ``torch.distributed`` mesh).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``), and
   show what the flash kernels compiled to: ``-Xptxas -v``'s registers and
   spills of every instantiation (hd 64, 80, 128 and 256, each dtype; none
   may spill), and the ``HGMMA`` (tensor-core) instructions in each one's
   SASS (``cuobjdump -sass``), which every bf16 instantiation must hold; then
   the two gossip mixes' registers and spills (none may spill), and the
   dense mix's SASS, which must hold FFMA and no HMMA or HGMMA;
3. kernels: at the main path's shapes (n = 100 clients, D = 1,756,426, the
   full-width ``cifar_cnn``), f32 and bf16, plus ragged shapes and pad
   slots, every kernel against its plain PyTorch version on the card with
   the stated tolerance; then its time (CUDA events) beside its bound, the
   plain version's time and one PyTorch library call's.  Both gossip mixes
   also run at the shapes their tilings straddle (n = 1, 9, 100, 128, 129;
   D = 3 and 4097 to 4099, rows 1, 2 and 3 mod 4 elements apart; banks at
   and a row past their allocation's start) and at the shapes that take
   their second kernels (dense n = 512, gather n = 8192, D = 64), and are
   timed at n = 8 and 100 in f32 and bf16.  The flash kernel
   runs at gemma3-12b's prefill shapes (B = 4, 16 on 8 heads, S = 2048,
   hd = 256, bf16, windows 1024 and 0), at the other dense decoders' (hd
   128, GQA groups 1, 4 and 16), at dbrx-132b's (B = 4, 48 on 8 heads,
   hd 128, group 6) and at edge cases, with its bf16 tolerance and a mask
   fault that must miss it, and is timed beside SDPA on the same inputs
   and mask, also at phase 11's shape (B = 2, 32 on 2 heads, hd 128) and
   phase 13's (dbrx-132b).  Then the three FL kernels at the delta bank's
   shape (n = 100, d_delta = 73,178 bf16 rows, 4 bytes off 16), on banks
   at and a row past their allocation's start, against their plain
   versions, and timed beside their bounds;
4. small parity: one round of every mix on the card against the same
   round on the CPU (the plain versions), on the same draws; then one
   round each of top-k + drops + delays + cold churn (sparse) and int8 +
   event trigger + proximal solver (dense), held to their flip bounds;
5. main path: ``FLTrainer`` with DFedSGPSM (5 local steps, batch 32,
   lr 0.01) on ``cifar_cnn``, synthetic CIFAR-10 split by Dirichlet(0.3)
   over 100 clients, kout k_out = 10: 3 rounds with the dense mix and 3
   with the sparse mix, with loss, accuracy, push-sum mass, wall time and
   kernel launches per round, peak memory, and a ``torch.profiler``
   breakdown of each mix's last round (device time by kernel, busy share);
6. crossover: the dense mix against the sparse mix at the same D, n from 4
   to 128 and k_max from 1 to n (device time, the median of 5 repeats),
   and the density rule's CUDA constants those times give, beside the ones
   ``kernels/ops.py`` ships;
7. serving: reduced gemma3-12b in f32, prefill and 4 greedy decode steps on
   the card against the same on the CPU (logits within tolerance, equal
   tokens); then the serving main path, ``repro_torch.launch.serve.main``
   with gemma3-12b at full width in bf16 (parameters drawn on the card), 4
   requests of 2048 prompt tokens and 16 new tokens: prefill time, decode
   ms/step and tokens/s, peak memory, flash launches per prefill (one per
   layer: 48), finite logits; then, on the model that run built, a steady
   second run, a profiled prefill and decode step split into the attention
   kernel, matmuls and the rest, and the decode check: the logits each new
   token was picked from against ``forward`` on the prompt extended by the
   new tokens, in bf16 at positions past the 1024-token window;
8. the scenario path: phase 5's model, data and topology under (A) top-k
   with error feedback + drops 0.2 + delays 2 + cold churn, sparse; (B)
   the proximal solver + int8 + a decaying event trigger whose threshold
   is chosen on the card, dense; (C) DFedAvgM + drops + churn, dense; (D)
   the rank-8 bf16 delta bank, sparse and dense: 3 rounds each with loss,
   push-sum mass (within 1e-3 of 100), live share, comm_fraction, wall
   time and launches (5 updates and 1 mix a round, 3 mixes under the
   delay bound), peak memory, profiles of A's and D's last rounds, and
   the compressors' and the delayed mix's costs;
9. checkpoints: phase 8's A trainer (comp, link and churn carries) and D
   sparse trainer (the bf16 delta bank, format v3 with ``__base__``)
   ``save`` to a temporary directory and ``restore`` into fresh trainers
   of their compositions: every array and generator state bit for bit,
   then one round from each bit for bit (``cudnn.deterministic`` set for
   the phase); A's file into A without its link scenario must raise;
   bytes written and save and restore seconds;
10. the paged store at the README's setting with half its population:
   ``FLTrainer(paged=True)`` with mnist_2nn (D = 199,210) on synthetic MNIST
   split by Dirichlet(0.3) over n = 2048 clients, k_active = 256, kout
   k_out = 4:
   the update and the gather at the paged shapes against their plain
   versions and bounds; c_max = 1280 resident and 2560 staging rows; a
   clean chunk corrupted before the cold round, which that round must
   rebuild from the template; one cold and 1 timed round with launches
   (5 updates at (256, D), 1 gather at (1280, D) with 5 slots), closure
   mass error, wall time and pager counters, then the write-back's drain
   and the time a round including it; store-wide mass n within 1e-3;
   ``save()``, and a reopen of the saved store under ``ChurnModel`` and a
   ``FaultInjector`` (a transient EIO on every file's first read): the
   last round's rows bit for bit, a round retrying the EIOs with the mass
   exact, and a corrupted chunk of trained rows that a read must refuse;
   the phase's wall time by step;
11. personalized serving: ``serve.main --clients 2 --rank 8`` with glm4-9b
   at full width in bf16 (a zero delta row on lane 0), prompts of 2048
   tokens and 16 new tokens: expand, prefill and decode times, peak
   memory, 40 flash launches at B = 2, H = 32, KV = 2; lane 0 against the
   dense serve of the base and lane 1 against ``forward`` on its own
   expanded weights, within phase 7's decode tolerance;
12. training: the flash backward kernel against its plain version at
   glm4-9b's training shape (B = 1, 32 on 2 heads, S = 4096, hd 128, bf16),
   at gemma3-12b's (hd 256, windows 1024 and 0), at hubert-xlarge's (2, 16
   on 16, 1500, hd 80, non-causal, f32 and bf16, a causal mask that must
   miss), at GQA groups 1, 4 and 16, f32 and bf16, edge lengths, with a
   mask fault that must miss its tolerance, and its time beside its bound
   and SDPA's backward (glm4-9b's, gemma3-12b's, llava-next-mistral-7b's
   and hubert's); reduced
   glm4-9b, 2 pods, 2 rounds of ``make_round_step`` on the card against
   the CPU (dense ``P_pod`` and the neighbor list); then the training main
   path, ``repro_torch.launch.train.run`` with glm4-9b at full width cut to
   4 layers, 2 pods, K = 2, 1 x 4096 tokens, 3 rounds: loss, accuracy,
   w_mass (2 within 1e-3), wall time and launches a round (32 flash
   backward, 32 forward, twice that under the config's remat, 1 dense
   mix), peak memory, a profiled round split by kind, and the mix at the
   bank's width (rows over 2^31 bytes) against its plain version;
13. serving the MoE family: reduced dbrx-132b and deepseek-v3-671b in f32,
   prefill and 4 greedy decode steps on the card against the CPU (the
   routers' differing choices counted); then each at full width in bf16
   (parameters drawn on the card), its depth cut to fit the card:
   dbrx-132b to 8 of 40 layers with 4 requests, deepseek-v3-671b to 2 of
   61 with 1 request, 2048 prompt tokens and 16 new through
   ``serve.generate``: prefill time, decode ms/step and tokens/s, peak
   memory, flash launches (one a dbrx layer, none for deepseek's MLA),
   each layer's largest expert load and drops, a steady second run, a
   profiled prefill and decode step split into the flash kernel, expert
   products, dispatch/combine, MLA and the rest; and the decode check
   against ``forward`` with the forward's expert choices and kept
   assignments pinned to the served path's, and a mutant (decode on the
   layer before's cache) that must miss its tolerance;
14. the vlm and masked_lm tasks: the flash kernel at hd 80 against its
   plain version (f32 and bf16, causal and non-causal, GQA groups 1 and 4,
   S = 1, 63, 65, 1000, and hubert-xlarge's (8, 16 on 16, 1500, hd 80)),
   with a mask one key late and a causal mask on hubert's inputs that must
   miss the tolerance, and its time at hubert's shape beside its bound, the
   plain version and SDPA; the forward at llava-next-mistral-7b's prefill
   (4, 32 on 8, 5760, hd 128) beside SDPA; reduced llava-next-mistral-7b
   (prefill and 4 greedy decode steps) and reduced hubert-xlarge widened
   to hd 80 (forward and loss) in f32, card against CPU; then
   llava-next-mistral-7b at full width and depth in bf16, 4 requests of
   2880 image embeddings and 2880 text tokens, 16 new tokens through
   ``serve.generate`` (32 flash launches a prefill, times, peak memory, a
   steady second run, a profiled prefill and decode step split into the
   flash kernel, matmuls and the rest, the projector's time), and the decode
   check with a mutant that decodes at positions leaving out the image
   prefix; and hubert-xlarge at full width and depth in bf16, 8 clips of
   1500 frames through ``ModelApi.forward`` and ``loss`` (48 hd 80 flash
   launches a call, frames/s, peak memory, a finite loss, a profiled
   forward), held to the same forward with the plain attention core, a
   causal mutant that must miss, and ``loss.backward()`` through the hd 80
   flash backward (48 calls, every gradient finite);
15. xlstm-350m and hymba-1.5b, the last two ids of the zoo: the flash
   kernels at hymba's GQA group 5 (25 on 5 heads, hd 64): the forward at its
   prefill (4, 25 on 5, 2176) with windows 1024 and 0, a ragged length in
   bf16 and f32, the backward at its training shape (1, 25 on 5, 2176) with
   the split of the group that ``split_for`` took, each with a mask fault
   that must miss, and their times beside their bounds and SDPA's; reduced
   xlstm-350m, hymba-1.5b and hymba at group 5, prefill and decode card
   against CPU, and a reduced pod round of each; xlstm-350m at full width
   and depth in bf16 through ``serve.main`` (4 x 1024 tokens, 32 new; its
   prefill is recurrent), its recurrent form held to ``forward`` in f32 on
   the same weights with a mutant that drops the carried matrix memory;
   hymba-1.5b at full width and depth in bf16 (4 x 2048 tokens after its
   128 meta tokens, 32 new; 32 flash launches a prefill), the SSM branch's
   time, and the decode check in f32 on the same weights with a mutant
   that leaves out the meta offset; then training: the CLI's default
   (``train.main(["--rounds", "2"])``, xlstm-350m at full width and depth)
   and hymba-1.5b cut to 4 layers at 1 x 2048 tokens, with loss, mass 2,
   round times, peak memory and launches;
16. training the masked_lm and vlm tasks: reduced hubert-xlarge (d_model
   320, 4 heads of hd 80: the f32 SIMT backward at hd 80) and reduced
   llava-next-mistral-7b, 2 pods, 2 rounds of ``make_round_step`` over
   ``make_batch`` draws on the card against the CPU; then hubert-xlarge at
   full width and depth (2 clips of 1500 frames a pod a step) and
   llava-next-mistral-7b at full width cut to 4 of 32 layers (1 x (2880
   image embeddings + 2880 text tokens)), 2 pods, K = 2, 2 rounds each:
   loss, accuracy, w_mass (2 within 1e-3), wall time and launches a round
   (hubert's 384 backward calls all at hd 80), peak memory and a profiled
   round split by kind;
17. personalized lanes of every family: reduced dbrx-132b,
   deepseek-v3-671b, llava-next-mistral-7b, hubert-xlarge (hd 80), xlstm-350m
   and hymba-1.5b in f32, 3 lanes of a rank-2 delta bank in a permuted
   client order, card against CPU (prefill and 3 decode steps; hubert its
   forward); then each at full width through ``serve.client_bank``,
   ``make_personalized_serve_step``'s expansion and ``serve.generate``,
   rank 8, lane 0 a zero row, 16 new tokens: llava-next-mistral-7b whole,
   2 x (2880 image embeddings + 1024 tokens); dbrx-132b at 2 of 40 layers,
   2 x 2048; deepseek-v3-671b at 1 of 61, 1 lane (a random row) x 2048;
   hymba-1.5b whole in f32, 2 x 1024 after its meta tokens; xlstm-350m
   whole in f32, 2 x 128; hubert-xlarge whole, 2 x 1500 frames (forward).
   Expand seconds and peak memory, prefill, decode ms/step, peak memory,
   the flash launches and shapes with the lanes as the batch, no FL
   kernel; lane 0 against the dense serve of the base, lane 1 against the
   forward of its own weights (a MoE model's routing pinned), lane 0
   against lane 1's forward must miss; deepseek's lane against its forward
   and the base's forward (must miss); hubert's lanes against their
   weights' forward alone, swapped lanes must miss;
18. the two-tier family and the row-sharded bank at phase 5's size
   (cifar_cnn, n = 100, K = 5, batch 32, lr 0.01; 4 pods of 25, k_out =
   10): the dense mix's row panel at (25, 100) x (100, D) and its edge
   shapes against its plain version and the square launch's rows, the
   gather at the two-tier inter list (100, 11), and for one shard's 25
   receivers over the gathered bank and over its rows and their halo
   (slots remapped), each timed beside its bound, its plain version and
   a library call; then 3 two-tier rounds in the dense form and in the
   operator form (intra ``bmm`` + the gather) on the same draws from one
   state, the banks held to each other and the mass 100; then
   ``FLTrainer(mesh=)`` on a one-rank NCCL clients mesh, ``gossip="xla"``
   and ``"halo"``, kout and two_tier, 2 rounds each, held to the
   unsharded program on the same draws, with the executor that ran and
   the round times;
19. the dry-run against the card: five records of
   ``repro_torch.launch.dryrun`` (glm4-9b at full width cut to 4 layers:
   prefill 2 x 4096, one decode step at B = 2 against a 4096-position
   cache, the train step at 1 x 4096, the ``multi`` round step over 2 pods
   at 2 x 4096; hubert-xlarge whole, forward at 8 x 1500), each traced on
   meta and then run on the card with drawn values: the counting mode
   around the card's run counts the trace's FLOPs and bytes and one kernel
   record a launch; the roofline time (FLOPs at the bf16 peak, bytes at the
   HBM rate, the larger) over the median of 3 timed runs must be at most
   1.05, and the predicted peak within 25% of the measured one; then the
   numbers the kernel table lacked (SDPA at glm4-9b's training forward
   shape, ``torch.matmul`` at hymba-1.5b's 4-layer pod bank); and rank 0's
   own steps of the 256-rank ``single`` mesh, run on the card as rank 0 of
   a fake world (glm4-9b's train step and xlstm-350m's; decode steps on a
   placed cache: glm4-9b at 4 layers, 128 x 32,768, and gemma3-12b at 6
   layers, long_500k's 1 x 524,288), each held to the meta trace as the
   whole steps are;
20. gemma3-12b's pod round: reduced card against CPU, then full width cut
   to one 5:1 period (6 of 48 layers), 2 pods, K = 2, 1 x 4096, 2 rounds,
   every flash backward call on the hd 256 tensor-core kernels;
21. the pod runtime on a one-rank NCCL world: glm4-9b at full width cut to
   4 layers, 2 pods as DTensors on a ``(1, 1, 1)`` ``("pod", "data",
   "model")`` mesh (``launch.mesh.init_world``, ``launch.steps.place_pods``,
   ``make_round_step`` under ``launch.sharding.use_mesh``), K = 2, 1 x 4096,
   2 rounds under ``gossip="xla"`` (dense ring) and ``"halo"`` (its neighbor
   list), each held to the mesh-less round on the same state and batches
   (params and w bit for bit or within 1e-5 of each leaf's magnitude, the
   leaves that differ named; loss and accuracy; launches a round and the
   kernels' symbols equal, or only which kernels ran where a profile
   missed events); both sides' round times and peak memory;
22. the pod runtime for every other family (xlstm-350m, hymba-1.5b, llava,
   hubert at full width cut in depth, dbrx-132b and deepseek-v3-671b
   reduced), held as phase 21's;
23. serving on the pod runtime's mesh (one NCCL rank): ``launch.serve.
   generate`` on the placed replica, its prefill building the cache as
   DTensors and its steps reading and writing the rank's blocks, for
   glm4-9b at full width cut to 4 layers (8 x 2048, 16 new tokens) and
   phase 22's decoding families, each held to the mesh-less ``generate``
   (tokens and logits bit for bit, the flash launches and the prefill's
   kernel symbols equal, as phase 21's); both sides' prefill s, decode ms a step and
   peak memory.

The line before the last is the JSON record of every kernel, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# The roofline's H100 SXM constants and each kernel's cost formula live in
# the port (``launch.mesh.HARDWARE``, ``roofline.cost``), which its dry-run
# shares.
from repro_torch.launch.mesh import HARDWARE  # noqa: E402
from repro_torch.roofline.cost import (  # noqa: E402
    bound_ms,
    dense_mix_cost,
    flash_backward_cost,
    flash_forward_cost,
    gather_cost,
    open_pairs,
    update_cost,
)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = HARDWARE["hbm_bw"]
F32_FLOP_PER_S = HARDWARE["peak_flops_f32"]
BF16_FLOP_PER_S = HARDWARE["peak_flops_bf16"]  # dense, on the tensor cores

N_CLIENTS = 100  # the paper's client count
CIFAR_CNN_DIM = 1_756_426
# cifar_cnn's delta bank at rank 8: 4 low-rank and 6 dense leaves; 2 mod 8,
# so bf16 rows start 4 bytes off a 16-byte boundary.
DELTA_DIM = 73_178


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def timed_ms(fn, dev, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of one call: CUDA events around ``iters`` calls on the
    card (after ``warmup``), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


# -- phase 3: kernels against their plain versions ----------------------------

# The mixes' tilings straddle n = 1, 9 (rows padded to 8), 100, 128 (the
# last n of the dense mix's resident kernel) and 129; D = 3, 4097, 4098 and
# 4099 start the rows 3, 1, 2 and 3 (mod 4) elements apart, so off 16 bytes.
MIX_SHAPES = [(n, d) for n in (1, 9, 100, 128, 129)
              for d in (3, 4097, 4098, 4099)]


def mix_banks(gen, n, d, dt, dev):
    """An (n, d) bank at the start of its allocation, and one a row in."""
    whole = torch.randn(n + 1, d, generator=gen, device=dev).to(dt)
    return whole[:n], whole[1:]


def matmul_path(dev, n: int) -> str:
    if dev.type != "cuda":
        return "plain version"
    # gossip_matmul.cu's RESIDENT_MAX_N
    return "resident kernel, n <= 128" if n <= 128 else "tiled kernel, n > 128"


def gather_path(dev, n: int, k_max: int, dt, m: int | None = None) -> str:
    """The gather's kernel for m receivers (n by default) over n rows."""
    from repro_torch.kernels import build

    if dev.type != "cuda":
        return "plain version"
    cols = build.load_library().gossip_gather_panel_cols(
        0 if dt == torch.float32 else 1, n if m is None else m, n, k_max)
    return f"panel kernel, {cols} columns" if cols else "row kernel"


def mix_times(dev, gen, d: int, iters: int) -> None:
    """Both mixes at n = 8 and 100 (kout, k_out = min(10, n - 1)), f32 and
    bf16, at the main path's D: time beside the bound (dense: the larger of
    its bytes and its f32 FLOP over the f32 peak; gather: its bytes) and
    the library call (``torch.matmul`` in f32, the ``einsum`` over
    ``X[idx]``)."""
    from repro_torch.core import topology
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import gossip_matmul as gm

    for n in (8, 100):
        P = topology.sample_kout(gen, n, min(10, n - 1))
        nl = topology.sample_kout_neighbors(gen, n, min(10, n - 1))
        k = nl.idx.shape[1]
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn(n, d, generator=gen, device=dev).to(dt)
            es = X.element_size()
            mm = timed_ms(lambda: gm.gossip_matmul(P, X), dev, iters)
            mm_lib = timed_ms(lambda: torch.matmul(P, X.float()), dev, iters)
            mm_b, mm_by = dense_mix_cost(n, n, d, es).bound_ms()
            ga = timed_ms(lambda: gg.gossip_gather(nl.idx, nl.wgt, X), dev,
                          iters)
            ga_lib = timed_ms(lambda: torch.einsum(
                "nk,nkd->nd", nl.wgt, X[nl.idx.long()].float()), dev, iters)
            ga_b, ga_by = gather_cost(n, n, k, d, es).bound_ms()
            print(f"  mix times n={n} D={d} {str(dt)[6:]}: gossip_matmul "
                  f"{mm:.4f} ms, bound {mm_b:.4f} ({mm_by}), "
                  f"{100 * mm_b / mm:.1f}% of it, torch.matmul (f32) "
                  f"{mm_lib:.4f}; gossip_gather k_max={k} {ga:.4f} ms, bound "
                  f"{ga_b:.4f} ({ga_by}), {100 * ga_b / ga:.1f}% of it, "
                  f"einsum {ga_lib:.4f}")
            del X


def kernel_phase(dev, n: int, d: int, iters: int = 10) -> dict:
    from repro_torch.core import topology
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import gossip_matmul as gm

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16_ulp = 2.0 ** -7
    rows = {}

    def bank(n_, d_, dt):
        return torch.randn(n_, d_, generator=gen, device=dev).to(dt)

    # fused_update_bank: the same IEEE operations in the same order as the
    # plain version (no contraction), so it must match bit for bit.
    err, err_row = 0.0, 0.0
    for (n_, d_) in [(n, d), (7, 1001), (5, 3), (1, d)]:
        for dt in (torch.float32, torch.bfloat16):
            X, G = bank(n_, d_, dt), bank(n_, d_, dt)
            V = bank(n_, d_, torch.float32)
            w = torch.rand(n_, generator=gen, device=dev) + 0.5
            got = fu.fused_update_bank(X, V, G, 0.9, 0.1, w)
            want = fu.fused_update_bank_plain(X, V, G, 0.9, 0.1, w)
            sync(dev)
            e = max(max_err(a, b) for a, b in zip(got, want))
            print(f"  fused_update_bank n={n_} D={d_} {str(dt)[6:]}: "
                  f"max|err| {e:.3e} (tolerance 0, bitwise)")
            check(e == 0.0, f"fused_update_bank disagrees ({n_}, {d_}, {dt})")
            if (n_, d_) == (n, d) and dt == torch.float32:
                err = e
            if (n_, d_) == (1, d) and dt == torch.float32:
                err_row = e
    X, G, V = bank(n, d, torch.float32), bank(n, d, torch.float32), bank(
        n, d, torch.float32)
    w = torch.rand(n, generator=gen, device=dev) + 0.5
    b, b_by = update_cost(n, d, 4).bound_ms()
    rows["fused_update_bank"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: fu.fused_update_bank(X, V, G, 0.9, 0.1, w), dev,
                    iters),
        plain_ms=timed_ms(
            lambda: fu.fused_update_bank_plain(X, V, G, 0.9, 0.1, w), dev,
            iters),
        bound_ms=b, bound_by=b_by, library_ms=None,
    )
    one_row = (X[:1], V[:1], G[:1], 0.9, 0.1, w[:1])
    row1 = timed_ms(lambda: fu.fused_update_bank(*one_row), dev, iters)
    row1_plain = timed_ms(lambda: fu.fused_update_bank_plain(*one_row), dev,
                          iters)
    b1, b1_by = update_cost(1, d, 4).bound_ms()
    print(f"  fused_update (one row, the n = 1 case) D={d}: {row1:.4f} ms, "
          f"bound {b1:.4f} ms, {100 * b1 / row1:.1f}% of bound; plain "
          f"{row1_plain:.4f} ms")
    rows["fused_update"] = dict(max_abs_err=err_row, ms=row1,
                                plain_ms=row1_plain, bound_ms=b1,
                                bound_by=b1_by, library_ms=None)
    del X, G, V

    # gossip_matmul: f32 sums in the kernel's own order (ascending k, one
    # FMA each); gossip_gather: the plain version's slot loop, bit for bit.
    # Both at the main path's shape, at the shapes their tilings straddle
    # (both kernels of each mix) and on banks whose rows start off 16 bytes.
    err = 0.0
    for (n_, d_) in [(n, d), (3, 5), *MIX_SHAPES, (512, 4099)]:
        P = topology.sample_kout(gen, n_, min(10, n_ - 1))
        cells = []
        for dt in (torch.float32, torch.bfloat16):
            for X in mix_banks(gen, n_, d_, dt, dev):
                got, want = gm.gossip_matmul(P, X), gm.gossip_matmul_plain(P, X)
                sync(dev)
                e = max_err(got, want)
                scale = float(want.float().abs().max())
                tol = (1e-6 if dt == torch.float32 else bf16_ulp) * scale
                cells.append(f"{str(dt)[6:]} {e / tol if tol else e:.3f}")
                check(e <= tol, f"gossip_matmul disagrees ({n_}, {d_}, {dt})")
                if (n_, d_) == (n, d) and dt == torch.float32:
                    err = max(err, e)
        print(f"  gossip_matmul n={n_} D={d_} ({matmul_path(dev, n_)}): max|err| / "
              f"tolerance (1e-6 max|Y| in f32, 2^-7 max|Y| in bf16; own bank, "
              f"one row in) {', '.join(cells)}")
    P = topology.sample_kout(gen, n, min(10, n - 1))
    X = bank(n, d, torch.float32)
    b, b_by = dense_mix_cost(n, n, d, 4).bound_ms()
    rows["gossip_matmul"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: gm.gossip_matmul(P, X), dev, iters),
        plain_ms=timed_ms(lambda: gm.gossip_matmul_plain(P, X), dev, iters),
        bound_ms=b, bound_by=b_by,
        library_ms=timed_ms(lambda: torch.matmul(P, X), dev, iters),
    )

    err = 0.0
    nl = topology.sample_kout_neighbors(gen, n, min(10, n - 1))
    padded = topology.sample_symmetric_neighbors(gen, n, 5)  # pads: weight 0
    pad_idx = torch.cat([nl.idx, nl.idx[:, :2]], dim=1).contiguous()
    pad_wgt = torch.cat([nl.wgt, torch.zeros_like(nl.wgt[:, :2])],
                        dim=1).contiguous()
    for lists, what in ((nl, "kout k_max=11"), (padded, "symmetric"),
                        (topology.NeighborList(pad_idx, pad_wgt),
                         "kout + 2 pad slots")):
        for dt in (torch.float32, torch.bfloat16):
            X = bank(n, d, dt)
            got = gg.gossip_gather(lists.idx, lists.wgt, X)
            want = gg.gossip_gather_plain(lists.idx, lists.wgt, X)
            sync(dev)
            e = max_err(got, want)
            print(f"  gossip_gather n={n} D={d} {what} {str(dt)[6:]} "
                  f"({gather_path(dev, n, lists.idx.shape[1], dt)}): max|err| "
                  f"{e:.3e} (tolerance 0, bitwise)")
            check(e == 0.0, f"gossip_gather disagrees ({what}, {dt})")
            if what.startswith("kout k") and dt == torch.float32:
                err = e
    for (n_, d_) in [(3, 5), *MIX_SHAPES, (512, 4099), (8192, 64)]:
        small = topology.sample_kout_neighbors(gen, n_, min(10, n_ - 1))
        cells = []
        for dt in (torch.float32, torch.bfloat16):
            for X in mix_banks(gen, n_, d_, dt, dev):
                e = max_err(gg.gossip_gather(small.idx, small.wgt, X),
                            gg.gossip_gather_plain(small.idx, small.wgt, X))
                cells.append(f"{str(dt)[6:]} {e:.1e}")
                check(e == 0.0, f"gossip_gather disagrees ({n_}, {d_}, {dt})")
        print(f"  gossip_gather n={n_} D={d_} k_max={small.idx.shape[1]} "
              f"({gather_path(dev, n_, small.idx.shape[1], torch.float32)} in f32): "
              f"max|err| (tolerance 0, bitwise; own bank, one row in) "
              f"{', '.join(cells)}")
    X = bank(n, d, torch.float32)
    k_max = nl.idx.shape[1]
    b, b_by = gather_cost(n, n, k_max, d, 4).bound_ms()
    rows["gossip_gather"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: gg.gossip_gather(nl.idx, nl.wgt, X), dev, iters),
        plain_ms=timed_ms(lambda: gg.gossip_gather_plain(nl.idx, nl.wgt, X),
                          dev, iters),
        bound_ms=b, bound_by=b_by,
        library_ms=timed_ms(
            lambda: torch.einsum("nk,nkd->nd", nl.wgt, X[nl.idx.long()]),
            dev, iters),
    )
    del X
    mix_times(dev, gen, d, iters)
    rows["flash_attention"] = flash_phase(dev, iters=iters)
    for name, r in rows.items():
        print(f"  {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
              f"bound; plain {r['plain_ms']:.4f} ms; library "
              + ("none" if r["library_ms"] is None
                 else f"{r['library_ms']:.4f} ms"))
    return rows


def delta_kernel_phase(dev, n: int = N_CLIENTS, d: int = DELTA_DIM,
                       iters: int = 10) -> None:
    """The three FL kernels at the scenario path's delta bank: n = 100 rows
    of d_delta = 73,178 bf16 (rows 4 bytes off 16), banks at and a row past
    their allocation's start, against their plain versions (the update and
    the gather bit for bit, the dense mix within 2^-7 of max|Y|); then each
    one's time beside its bound, its plain version's and the library's.
    A call here takes about as long as its launch takes on the host, so on
    the card the times are device times (:func:`queued_ms`)."""
    from repro_torch.core import topology
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import gossip_matmul as gm

    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    P = topology.sample_kout(gen, n, min(10, n - 1))
    nl = topology.sample_kout_neighbors(gen, n, min(10, n - 1))
    w = torch.rand(n, generator=gen, device=dev) + 0.5
    cells = []
    for (X, G), V in zip(zip(mix_banks(gen, n, d, bf16, dev),
                             mix_banks(gen, n, d, bf16, dev)),
                         mix_banks(gen, n, d, torch.float32, dev)):
        at = "own bank" if X.data_ptr() % 16 == 0 else (
            f"one row in ({X.data_ptr() % 16} B off 16)")
        e_up = max(max_err(a, b) for a, b in zip(
            fu.fused_update_bank(X, V, G, 0.9, 0.01, w),
            fu.fused_update_bank_plain(X, V, G, 0.9, 0.01, w)))
        want = gm.gossip_matmul_plain(P, X)
        e_mm = max_err(gm.gossip_matmul(P, X), want)
        tol = 2.0 ** -7 * float(want.float().abs().max())
        e_ga = max_err(gg.gossip_gather(nl.idx, nl.wgt, X),
                       gg.gossip_gather_plain(nl.idx, nl.wgt, X))
        sync(dev)
        cells.append(f"{at}: fused_update_bank {e_up:.1e} (0), gossip_matmul "
                     f"{e_mm / tol:.3f} of 2^-7 max|Y|, gossip_gather "
                     f"{e_ga:.1e} (0)")
        check(e_up == 0.0, f"fused_update_bank disagrees at d_delta ({at})")
        check(e_mm <= tol, f"gossip_matmul disagrees at d_delta ({at})")
        check(e_ga == 0.0, f"gossip_gather disagrees at d_delta ({at})")
    print(f"  bf16 delta bank n={n} d_delta={d}: " + "; ".join(cells))
    X, G = (torch.randn(n, d, generator=gen, device=dev).to(bf16)
            for _ in range(2))
    V = torch.randn(n, d, generator=gen, device=dev)
    k = nl.idx.shape[1]
    rows = {
        "fused_update_bank": (
            lambda: fu.fused_update_bank(X, V, G, 0.9, 0.01, w),
            lambda: fu.fused_update_bank_plain(X, V, G, 0.9, 0.01, w), None,
            update_cost(n, d, 2).bound_ms()),
        "gossip_matmul": (
            lambda: gm.gossip_matmul(P, X), lambda: gm.gossip_matmul_plain(P, X),
            lambda: torch.matmul(P, X.float()),
            dense_mix_cost(n, n, d, 2).bound_ms()),
        "gossip_gather": (
            lambda: gg.gossip_gather(nl.idx, nl.wgt, X),
            lambda: gg.gossip_gather_plain(nl.idx, nl.wgt, X),
            lambda: torch.einsum("nk,nkd->nd", nl.wgt, X[nl.idx.long()].float()),
            gather_cost(n, n, k, d, 2).bound_ms()),
    }
    def device_ms(fn):
        return (queued_ms(fn, iters) if dev.type == "cuda"
                else timed_ms(fn, dev, iters))

    for name, (kern, plain, lib, (b, by)) in rows.items():
        ms = device_ms(kern)
        print(f"  {name} bf16 n={n} d_delta={d}: {ms:.4f} ms, bound {b:.4f} ms "
              f"({by}), {100 * b / ms:.1f}% of it; plain "
              f"{device_ms(plain):.4f} ms; library "
              + ("none" if lib is None else f"{device_ms(lib):.4f} ms"))


# gemma3-12b's attention at phase 7's prefill: 4 requests of 2048 tokens, 16
# query heads on 8 kv heads of hd = 256, bf16.  40 of its 48 layers are local
# (a 1024-token window), 8 are global.
FLASH_SHAPE = (4, 16, 8, 2048, 256)
LOCAL_WINDOW = 1024
# The other dense decoders' attention at the same prefill (causal, no
# window, hd 128): (H, KV) of their configs, GQA groups 1, 4 and 16.
OTHER_DECODERS = {"codeqwen1.5-7b": (32, 32), "phi3-medium-14b": (40, 10),
                  "glm4-9b": (32, 2)}
# glm4-9b's attention at phase 11's personalized prefill: 2 lanes of 2048
# tokens, 32 query heads on 2 kv heads of hd = 128 (GQA group 16), bf16.
PERSONAL_SHAPE = (2, 32, 2, 2048, 128)
# dbrx-132b's attention at phase 13's prefill: 4 requests of 2048 tokens, 48
# query heads on 8 kv heads of hd = 128 (GQA group 6), bf16, causal.
DBRX_SHAPE = (4, 48, 8, 2048, 128)


def flash_phase(dev, shape=FLASH_SHAPE, window=LOCAL_WINDOW,
                iters: int = 10, others=OTHER_DECODERS,
                personal=PERSONAL_SHAPE, dbrx=DBRX_SHAPE) -> dict:
    """The flash kernel against its plain version: at gemma3-12b's prefill
    shapes (local and global layers), at the other dense decoders' (hd 128,
    groups 1, 4 and 16), at dbrx-132b's (hd 128, group 6) and at edge cases
    (hd 64, 128 and 256, GQA groups 1, 2, 4 and 16, non-causal with and
    without a window, ragged S, f32); a mask fault that must miss the
    tolerance, at gemma3-12b's and dbrx-132b's shapes; then its time beside
    its bound, the plain version's and SDPA's on the same bf16 inputs.

    Tolerance: in f32 (the SIMT kernel) the kernel sums scores, the softmax
    denominator and P.V in its own (online, tile by tile) order, 2e-5 on
    outputs of magnitude about 1.  In bf16 (the tensor-core kernel) it also
    rounds P to bf16 before P.V: ``flash_attention.bf16_tolerance``, 2e-5 +
    2^-8 max|v| over the row's open keys + 2^-7 |out| (its docstring derives
    it).  The mask fault runs the kernel on q moved down one row, so each
    row attends with its mask one key late (on the global layer: the causal
    diagonal one key off, as the CPU tests' mutant); it must miss."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, kv, s, hd = shape
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        (shape, bf16, True, window),  # a local layer
        (shape, bf16, True, 0),  # a global layer
        (shape, f32, True, window),
        ((2, 8, 8, 1000, 128), f32, True, 0),  # group 1, ragged
        ((2, 8, 4, 100, 64), bf16, False, 0),  # group 2
        ((2, 8, 2, 12, 128), bf16, True, 5),  # group 4
        ((2, 16, 4, 1000, 64), f32, False, 100),
        ((1, 4, 1, 100, 256), f32, True, 33),
        ((2, 8, 8, 1000, 128), bf16, True, 0),  # group 1, ragged
        ((2, 16, 4, 1000, 64), bf16, False, 100),  # non-causal, a window
        ((1, 4, 1, 300, 256), bf16, True, 33),  # ragged at hd 256
        ((1, 32, 2, 777, 128), bf16, True, 0),  # group 16, ragged
    ]
    cases += [((b, nh, nkv, s, 128), bf16, True, 0)
              for nh, nkv in others.values()]
    cases.append((personal, bf16, True, 0))
    cases.append((dbrx, bf16, True, 0))

    def qkv(shp, dt):
        b_, h_, kv_, s_, hd_ = shp
        return [torch.randn(b_, n_, s_, hd_, generator=gen, device=dev).to(dt)
                for n_ in (h_, kv_, kv_)]

    def tolerance(v, want, causal, win):
        if want.dtype == bf16:
            return fa.bf16_tolerance(v, want, causal, win)
        return torch.full_like(want, 2e-5, dtype=f32)

    errs = {}
    for shp, dt, causal, win in cases:
        q, k, v = qkv(shp, dt)
        got = fa.flash_attention(q, k, v, causal, win)
        want = fa.flash_attention_plain(q, k, v, causal, win)
        sync(dev)
        tol = tolerance(v, want, causal, win)
        ratio = float(((got.float() - want.float()).abs() / tol).max())
        e = max_err(got, want)
        print(f"  flash_attention (B,H,KV,S,hd)={shp} {str(dt)[6:]} "
              f"causal={causal} window={win}: max|err| {e:.3e}, "
              f"{ratio:.3f} of its tolerance ("
              + ("2e-5 + 2^-8 max_row|v| + 2^-7 |out|)" if dt == bf16
                 else "2e-5)"))
        check(ratio <= 1.0,
              f"flash_attention disagrees ({shp}, {dt}, {causal}, {win})")
        errs[shp, dt, causal, win] = e
        if shp in (shape, dbrx) and dt == bf16:  # the mask fault must miss
            fault = fa.flash_attention(torch.roll(q, 1, 2), k, v, causal, win)
            sync(dev)
            miss = float(((fault[:, :, 1:].float() - want[:, :, :-1].float())
                          .abs() / tol[:, :, :-1]).max())
            print(f"    mask one key late (q moved down one row): "
                  f"{miss:.3f} of the tolerance (must exceed 1)")
            check(miss > 1.0, f"the bf16 tolerance misses a mask fault "
                              f"({shp}, window {win})")
            del fault
        del q, k, v, got, want, tol

    def timed(shp, win, what):
        b_, h_, kv_, s_, hd_ = shp
        q, k, v = qkv(shp, bf16)
        cost = flash_forward_cost(b_, h_, kv_, s_, hd_, True, win,
                                  q.element_size())
        flops = cost.flops
        bound, by = cost.bound_ms(BF16_FLOP_PER_S)
        if win:
            ar = torch.arange(s_, device=dev)
            mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :]
                                                   < win)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        r = dict(
            max_abs_err=errs[shp, bf16, True, win],
            ms=timed_ms(lambda: fa.flash_attention(q, k, v, True, win), dev,
                        iters),
            plain_ms=timed_ms(
                lambda: fa.flash_attention_plain(q, k, v, True, win), dev,
                max(iters // 5, 1)),
            bound_ms=bound, bound_by=by,
            library_ms=timed_ms(lib, dev, iters),
        )
        lib_err = max_err(lib(), fa.flash_attention_plain(q, k, v, True, win))
        print(f"  flash_attention {what} (B,H,KV,S,hd)={shp} window {win}: "
              f"{r['ms']:.4f} ms for {flops:.4g} FLOP "
              f"({flops / r['ms'] / 1e9:.2f} TFLOP/s), bound {bound:.4f} ms at "
              f"the bf16 tensor-core peak ({by}), {100 * bound / r['ms']:.1f}% "
              f"of it; plain {r['plain_ms']:.4f} ms; SDPA "
              f"{r['library_ms']:.4f} ms (max|SDPA - plain| {lib_err:.3e}); "
              f"kernel/SDPA {r['ms'] / r['library_ms']:.3f}")
        return r

    row = timed(shape, window, "gemma3-12b local layer")  # the JSON row
    timed(shape, 0, "gemma3-12b global layer")
    for name, (nh, nkv) in others.items():
        timed((b, nh, nkv, s, 128), 0, name)
    timed(personal, 0, "glm4-9b personalized (phase 11)")
    timed(dbrx, 0, "dbrx-132b (phase 13)")
    return row


_SASS = []


def hgmma_counts(pattern: str):
    """{mangled name: count of tensor-core ``HGMMA`` instructions} for each
    function of the built library whose name holds ``pattern``, from
    ``cuobjdump -sass`` (run once); None where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    from repro_torch.kernels import build

    if not _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if not os.path.exists(tool):
            return None
        _SASS.append(subprocess.run([tool, "-sass", str(build.library_path())],
                                    capture_output=True, text=True, check=True,
                                    timeout=300).stdout)
    counts, fn = {}, None
    for line in _SASS[0].splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if pattern in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def flash_build_evidence() -> None:
    """What the flash kernels compiled to: ``nvcc -Xptxas -v``'s lines for
    them (registers, spills; their shared memory is dynamic), and the
    count of tensor-core ``HGMMA`` instructions in each one's SASS
    (``cuobjdump -sass`` of the built library, where the toolkit has it).
    Every instantiation, the four head dims (64, 80, 128, 256) of each
    dtype, must be there and spill nothing, and every tensor-core (tc)
    one must hold HGMMA."""
    import re

    from repro_torch.kernels import build

    log = build.build_log()
    if "== flash_attention.cu" not in log:
        print("  no build log (the library was built without one)")
    part = log[log.find("== flash_attention.cu"):].split("\n== ")[0]
    for line in part.splitlines()[1:]:
        if "ptxas" in line or "bytes stack frame" in line:
            print("    " + line.strip()[:150])
    built, fn = {}, None
    for line in part.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = re.search(r"(2tc|4simt)22flash_attention_kernelI(?:f)?Li(\d+)E",
                             m.group(1))
            fn = (("tc" if inst.group(1) == "2tc" else "simt"),
                  int(inst.group(2))) if inst else None
            if fn:
                built[fn] = [None, None]
        elif fn and "spill stores" in line:
            built[fn][1] = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                         line))
        elif fn and "Used" in line and "registers" in line:
            built[fn][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    print("  flash forward instantiations (registers, bytes spilled): " + "; ".join(
        f"{kind} hd {hd} {regs}, {spill}"
        for (kind, hd), (regs, spill) in sorted(built.items())))
    for kind in ("tc", "simt"):
        for hd in (64, 80, 128, 256):
            check((kind, hd) in built, f"no {kind} flash kernel at hd {hd} "
                                       "in the build log")
            check(built[kind, hd][1] == 0,
                  f"the {kind} flash kernel at hd {hd} spills "
                  f"{built[kind, hd][1]} bytes")
    counts = hgmma_counts("flash_attention_kernel")
    if counts is None:
        print("  cuobjdump not found: no SASS count")
        return
    for fn, n in counts.items():
        kind = "tc" if "2tc22flash" in fn else "simt"
        inst = re.search(r"kernelI(?:f)?Li(\d+)E", fn)
        print(f"  SASS {kind} flash_attention_kernel hd "
              f"{inst.group(1) if inst else '?'}: {n} HGMMA instructions")
        if kind == "tc":
            check(n > 0, f"no HGMMA in {fn}")
    check(any("2tc22flash" in fn for fn in counts),
          "no tensor-core flash kernel in the library's SASS")


MIX_KERNELS = ("mix_resident_kernel", "mix_tiled_kernel", "gather_panels_kernel",
               "gather_rows_kernel")


def mix_build_evidence() -> None:
    """What the two mixes compiled to: ``nvcc -Xptxas -v``'s registers and
    spills for every instantiation of their kernels (none may spill), and
    the FFMA and tensor-core (HMMA, HGMMA) instructions in each dense-mix
    kernel's SASS: the dense mix is a true f32 product, so every one of its
    kernels must hold FFMA and no tensor-core instruction."""
    import re
    import shutil

    from repro_torch.kernels import build

    def short(fn):
        kind = next((k for k in MIX_KERNELS if k in fn), None)
        if kind is None:
            return None
        dt = "bf16" if "nv_bfloat16" in fn else "f32"
        args = re.findall(r"Li(\d+)E", fn.split(kind, 1)[1])
        return f"{kind}<{', '.join([dt, *args])}>"

    kernels, fn = {}, None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = short(m.group(1))
            if fn:
                kernels[fn] = [None, None]
        elif fn and "spill stores" in line:
            kernels[fn][1] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", line))
        elif fn and "Used" in line and "registers" in line:
            kernels[fn][0] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
    check(bool(kernels), "no ptxas lines for the mix kernels in the build log")
    by_kind = {}
    for fn, (regs, spill) in kernels.items():
        by_kind.setdefault(fn.split("<")[0], []).append(
            f"{fn[fn.index('<'):]} {regs} regs, {spill} B spilled")
    for kind, lines in by_kind.items():
        print(f"  ptxas {kind}: " + "; ".join(lines))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found: no SASS count")
    sass = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short(m.group(1))
            fn = fn if fn and fn.startswith("mix_") else None
            if fn:
                counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "FFMA" in line
            counts[fn][1] += "HMMA" in line or "HGMMA" in line
    check(bool(counts), "no dense-mix kernel in the library's SASS")
    print("  SASS of the dense mix (FFMA, tensor-core instructions): " + "; ".join(
        f"{fn} {ffma}, {tc}" for fn, (ffma, tc) in counts.items()))
    for fn, (regs, spill) in kernels.items():
        check(spill == 0, f"{fn} spills {spill} bytes")
    for fn, (ffma, tc) in counts.items():
        check(ffma > 0 and tc == 0, f"{fn}: {ffma} FFMA, {tc} HMMA/HGMMA")


# -- phase 4: the card's round against the CPU's, same draws ------------------

def small_parity(dev) -> None:
    """One DFedSGPSM round of mnist_2nn (n = 8) on the card and on the CPU
    from the same state and the same draws, dense and sparse mix.  Both
    sides compute in f32 (TF32 off); cuBLAS/cuDNN and the CPU sum in
    their own orders, so the banks agree to 1e-5 of their magnitude."""
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo
    from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.small import mnist_2nn

    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], 8, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=128)
    model = mnist_2nn()
    topo = TopologyConfig(kind="kout", n_clients=8, k_out=2)
    algo = make_algo("dfedsgpsm", local_steps=3)
    for gossip in ("dense", "sparse"):
        cpu = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                        gossip=gossip, device="cpu")
        card = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                         gossip=gossip, device=dev)
        card.state = card.state._replace(params=cpu.state.params.to(dev))
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            P = cpu.program.mixing_matrix(gen, cpu.state)
            idx = torch.randint(0, 128, (3, 8, 32), generator=gen)
            m_cpu = cpu.run_round({"P": P, "batch_idx": idx})
            m_card = card.run_round({"P": P, "batch_idx": idx})
        want = cpu.state.params
        got = card.state.params.cpu()
        e = max_err(got, want)
        tol = 1e-5 * float(want.abs().max())
        dw = max_err(card.state.w.cpu(), cpu.state.w)
        dl = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
        print(f"  {gossip}: bank max|err| {e:.3e} (tolerance {tol:.3e}), "
              f"w {dw:.3e} (1e-6), loss {dl:.3e} (1e-5)")
        check(e <= tol and dw <= 1e-6 and dl <= 1e-5,
              f"card and CPU rounds disagree ({gossip})")


class Spy:
    """Delegates to ``inner`` and records each call of its ``method``: the
    arguments and the result."""

    def __init__(self, inner, method):
        self.__dict__.update(inner=inner, method=method, calls=[])

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name != self.method:
            return attr

        def call(*args, **kw):
            out = attr(*args, **kw)
            self.calls.append((args, out))
            return out

        return call


def spied(trainer):
    """``trainer`` with its compressor's ``apply`` and its mixer's
    ``mix_round`` recorded (the pre-compression bank, the payload, the
    operator after churn and drops)."""
    import dataclasses

    prog = trainer.program
    trainer.program = dataclasses.replace(
        prog, compressor=Spy(prog.compressor, "apply"),
        mixer=Spy(prog.mixer, "mix_round"))
    return trainer


def moved(state, dev, like):
    """``state`` with every tensor on ``dev`` and the random streams of
    ``like`` (a state of the same program on ``dev``)."""
    def mv(x):
        return x.to(dev) if torch.is_tensor(x) else x

    link, churn = state.link, state.churn
    if link:
        link = like.link._replace(bufx=mv(link.bufx), bufw=mv(link.bufw),
                                  last=mv(link.last))
    if churn:
        churn = like.churn._replace(live=mv(churn.live), tpl=mv(churn.tpl))
    return state._replace(params=mv(state.params), mom=mv(state.mom),
                          w=mv(state.w), losses=mv(state.losses),
                          comp=mv(state.comp), key=like.key, link=link,
                          churn=churn)


def dense_operator(P, n):
    from repro_torch.core import topology

    if isinstance(P, topology.NeighborList):
        return topology.dense_from_neighbors(P, n)
    return P.float()


def event_threshold(norms) -> float:
    """A threshold between two adjacent drift norms near the median, the
    pair with the widest relative gap among the middle half, so that about
    half the clients transmit and every norm lies at least 1e-3 (relative)
    away from it."""
    v = sorted(float(x) for x in norms)
    lo, hi = len(v) // 4, max(3 * len(v) // 4, len(v) // 4 + 1)
    i = max(range(lo, min(hi, len(v) - 1)), key=lambda j: v[j + 1] / v[j])
    tau = math.sqrt(v[i] * v[i + 1])
    check(min(abs(x / tau - 1.0) for x in v) >= 1e-3,
          f"no threshold 1e-3 away from every drift norm: {v}")
    return tau


def scenario_parity(dev) -> None:
    """One round of two scenario compositions of mnist_2nn (n = 8, kout
    k_out = 2, 3 local steps) on the card against the same round on the CPU,
    from the same state on the same draws (operator, minibatches, drop
    uniforms, delays, churn coins):

    * topk_ef + drop 0.2 + delay 2 + cold churn, sparse mix;
    * int8 + event trigger (decay 0.9) + proximal solver, dense mix, the
      threshold chosen from the CPU's drift norms (1e-3 away from each).

    Card and CPU sum in their own orders (cuDNN, the kernels), about 1e-7
    relative, and a lossy compressor can flip a coordinate where the noise
    meets a rounding boundary or the k-th magnitude: receiver i's row of
    the mixed bank and of the in-flight buffer must lie within 1e-5 max|X|
    + sum_{j != i} P[i, j] step_j, with P the operator after churn and
    drops and step_j one int8 step (max|x_j| / 127) or sender j's k-th
    magnitude (both from the CPU's pre-compression bank); the EF residual
    within 1e-5 max|X| + max_j kth_j; w within 1e-6, loss, w_mass within
    1e-5, liveness and comm_fraction equal."""
    from repro_torch.core import (ChurnModel, FLTrainer, LinkModel,
                                  TopologyConfig, make_algo, stages, topology)
    from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.small import mnist_2nn

    train, _ = make_dataset("mnist", 1200, 100, seed=0)
    parts = dirichlet_partition(train["y"], 8, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=128)
    model = mnist_2nn()
    topo = TopologyConfig(kind="kout", n_clients=8, k_out=2)
    cases = {
        "topk_ef + drop 0.2 + delay 2 + cold churn, sparse": dict(
            algo=make_algo("dfedsgpsm", local_steps=3, compressor="topk_ef"),
            gossip="sparse", link=LinkModel(drop=0.2, delay=2),
            churn=ChurnModel(fail_prob=0.3, recover_prob=0.5,
                             permanent_frac=0.2, resurrect="cold")),
        "int8 + event trigger + proximal, dense": dict(
            algo=make_algo("dfedsgpsm", local_steps=3, solver="proximal",
                           prox_mu=0.05, compressor="int8_rows"),
            gossip="dense", link=LinkModel(event_threshold=1.0,
                                           event_decay=0.9)),
    }
    for what, kw in cases.items():
        def trainer(device, kw=kw):
            return FLTrainer(model.loss, model.init, cdata, seed=0,
                             topo=topo, device=device, **kw)

        gen = torch.Generator().manual_seed(1)
        cpu = spied(trainer("cpu"))
        P = cpu.program.mixing_matrix(gen, cpu.state)
        draws = {"P": P,
                 "batch_idx": torch.randint(0, 128, (3, 8, 32), generator=gen)}
        if kw["link"].drop:
            draws["drop"] = topology.draw_drops(gen, P)
        if kw["link"].delay:
            draws["delay"] = stages.draw_delays(gen, P, kw["link"].delay)
        if kw.get("churn"):
            draws["churn"] = topology.draw_churn(gen, 8)
        if kw["link"].event_threshold:
            # Choose the threshold from this round's drift norms on the CPU.
            start = cpu.state
            cpu.run_round(draws)
            Xc = cpu.program.compressor.calls[0][1][1]
            norms = torch.sqrt(((Xc - start.params) ** 2).sum(dim=1))
            tau = event_threshold(norms)
            print(f"  {what}: event threshold {tau:.6g} (drift norms "
                  f"{', '.join(f'{float(x):.4f}' for x in sorted(norms))})")
            kw["link"] = LinkModel(event_threshold=tau, event_decay=0.9)
            cpu = spied(trainer("cpu"))
        card = trainer(dev)
        card.state = moved(cpu.state, dev, card.state)
        m_cpu = cpu.run_round(draws)
        m_card = card.run_round(draws)
        (comp_prev, X_pre), _ = cpu.program.compressor.calls[-1]
        Pm = dense_operator(cpu.program.mixer.calls[-1][0][0], 8)
        y = X_pre.float() + (comp_prev if torch.is_tensor(comp_prev) else 0.0)
        if kw["algo"].compressor == "int8_rows":
            step = X_pre.float().abs().amax(dim=1) / 127.0
        else:
            k = max(int(0.05 * y.shape[1]), 1)
            step = torch.topk(y.abs(), k, dim=1).values[:, -1]
        flips = ((Pm * (1 - torch.eye(8))) @ step)[:, None]
        want, got = cpu.state, card.state
        scale = float(want.params.abs().max())
        bound = 1e-5 * scale + flips
        ratio = float(((got.params.cpu() - want.params).abs() / bound).max())
        parts_ = [f"bank {ratio:.3f} of its bound"]
        ok = ratio <= 1.0
        if want.link and torch.is_tensor(want.link.bufx):
            r_buf = float(((got.link.bufx.cpu() - want.link.bufx).abs()
                           / bound).max())
            e_bw = max_err(got.link.bufw.cpu(), want.link.bufw)
            parts_.append(f"bufx {r_buf:.3f} of it, bufw {e_bw:.1e} (1e-6)")
            ok &= r_buf <= 1.0 and e_bw <= 1e-6
        if torch.is_tensor(want.comp):
            e_c = max_err(got.comp.cpu(), want.comp)
            tol_c = 1e-5 * scale + float(step.max())
            parts_.append(f"EF residual {e_c / tol_c:.3f} of 1e-5 max|X| + "
                          "max kth")
            ok &= e_c <= tol_c
        if want.churn:
            same = torch.equal(got.churn.live.cpu(), want.churn.live)
            parts_.append(f"liveness equal: {same} "
                          f"{want.churn.live.tolist()}")
            ok &= same
        e_w = max_err(got.w.cpu(), want.w)
        ok &= e_w <= 1e-6
        for key in m_cpu:
            a, b = float(m_card[key]), float(m_cpu[key])
            exact = key == "comm_fraction"
            ok &= (a == b) if exact else abs(a - b) <= 1e-5
        parts_.append(f"w {e_w:.1e} (1e-6); metrics card "
                      + ", ".join(f"{k} {float(v):.6f}" for k, v in
                                  m_card.items())
                      + "; CPU " + ", ".join(f"{k} {float(v):.6f}" for k, v in
                                             m_cpu.items()))
        print(f"  {what}: " + "; ".join(parts_))
        check(ok, f"card and CPU scenario rounds disagree ({what})")


# -- phase 5: the main path ---------------------------------------------------

def print_profile(prof, wall_s: float, top: int = 12, also=(),
                  skip=()) -> list:
    """Device time by kernel over one profiled round, and the device's busy
    share of the round's wall time: the union of the kernels' intervals
    (kernels on several streams may overlap, so their summed time can
    exceed the wall).  Only device-side events count (an operator's own
    row repeats its kernels' time), and not the profiler's own buffer
    traffic, nor the device-side spans of the ``record_function`` ranges
    named in ``skip``.  Kernels whose names hold a word of ``also`` are
    listed after the top ones wherever they rank.  Returns the kernels'
    rows of ``key_averages``."""
    from torch.autograd import DeviceType

    overhead = ("Buffer Flush", "Activity Buffer Request") + tuple(skip)
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name not in overhead
    )
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in overhead
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    summed_us = sum(e.self_device_time_total for e in rows)
    print(f"    device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms "
          f"wall ({100 * busy_us / 1e6 / wall_s:.1f}%), kernel time summed "
          f"over streams {summed_us / 1e3:.1f} ms; top kernels:")
    for e in rows[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    for e in rows[top:]:
        if any(w in e.key.lower() for w in also):
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
                  f"{e.key[:90]} (rank {rows.index(e) + 1})")
    return rows


def counters() -> dict:
    """Each kernel's launch counter, as (wrapper module, attribute), or
    (module, a dict attribute, its key).  The
    one-row update is the (1, D) launch of the bank kernel: both counts go
    up for it.  The flash backward counts its calls and, beside them, the
    kernels those calls launched (its passes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import gossip_matmul as gm

    return {"fused_update_bank": (fu, "launches"),
            "fused_update": (fu, "row_launches"),
            "gossip_matmul": (gm, "launches"), "gossip_gather": (gg, "launches"),
            "flash_attention": (fa, "launches"),
            # the flash launches at hd 80 (hubert-xlarge), also counted above
            "flash_attention_hd80": (fa, "head_dim_launches", 80),
            "flash_attention_backward": (fa, "backward_launches"),
            # the backward's calls at hd 80, also counted above
            "flash_attention_backward_hd80": (fa, "backward_head_dim_launches",
                                              80),
            # and at hd 256 (gemma3-12b)
            "flash_attention_backward_hd256": (
                fa, "backward_head_dim_launches", 256),
            "flash_attention_backward_kernels": (fa, "backward_kernel_launches")}


@contextlib.contextmanager
def kernel_shapes():
    """Record the tensor shapes each FL and flash kernel wrapper is called
    with through ``kernels.ops`` while the block runs: ``{kernel: [(shape
    of each tensor argument, ...), ...]}``."""
    from repro_torch.kernels import ops as kops

    names = {"fused_update_bank": "_bank_kernel",
             "gossip_gather": "gossip_gather",
             "flash_attention": "_flash_kernel"}
    seen = {k: [] for k in names}
    saved = {attr: getattr(kops, attr) for attr in names.values()}

    def spy(kernel, fn):
        def call(*args, **kw):
            seen[kernel].append(tuple(tuple(a.shape) for a in args
                                      if isinstance(a, torch.Tensor)))
            return fn(*args, **kw)
        return call

    for kernel, attr in names.items():
        setattr(kops, attr, spy(kernel, saved[attr]))
    try:
        yield seen
    finally:
        for attr, fn in saved.items():
            setattr(kops, attr, fn)


def zero_counts() -> None:
    for mod, attr, *key in counters().values():
        if key:
            getattr(mod, attr)[key[0]] = 0
        else:
            setattr(mod, attr, 0)


def read_counts() -> dict:
    out = {}
    for name, (mod, attr, *key) in counters().items():
        value = getattr(mod, attr)
        out[name] = value[key[0]] if key else value
    return out


def cifar_data(dev, n_clients: int = N_CLIENTS, n_train: int = 50_000,
               n_test: int = 10_000, per_client: int = 500):
    """Synthetic CIFAR-10 split by Dirichlet(0.3) over ``n_clients``, on
    ``dev``: ``(client_data, test_data)``."""
    from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
    from repro_torch.data.synthetic import make_dataset

    t0 = time.perf_counter()
    train, test = make_dataset("cifar10", n_train, n_test, seed=0)
    parts = dirichlet_partition(train["y"], n_clients, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=per_client)
    cdata = {k: torch.as_tensor(v, device=dev) for k, v in cdata.items()}
    test = {k: torch.as_tensor(v, device=dev) for k, v in test.items()}
    print(f"  data: {n_train} synthetic CIFAR-10 images, Dirichlet(0.3) over "
          f"{n_clients} clients, {per_client} rows each "
          f"({time.perf_counter() - t0:.1f} s to make)")
    return cdata, test


def main_path(dev, n_clients: int = N_CLIENTS, rounds: int = 3,
              n_train: int = 50_000, n_test: int = 10_000,
              per_client: int = 500, local_steps: int = 5,
              data=None) -> dict:
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo
    from repro_torch.models.small import cifar_cnn

    cdata, test = data or cifar_data(dev, n_clients, n_train, n_test,
                                     per_client)
    model = cifar_cnn()
    # lr 0.01: at the default 0.1 (SAM + momentum 0.9) this CNN diverges on
    # the synthetic data within its first local steps, in the JAX reference
    # as in the port (loss NaN by the second round).
    algo = make_algo("dfedsgpsm", local_steps=local_steps, batch_size=32,
                     lr=0.01)
    topo = TopologyConfig(kind="kout", n_clients=n_clients, k_out=10)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the main path's counts start here
    for gossip in ("dense", "sparse"):
        tr = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                       gossip=gossip, device=dev)
        check(tr.spec.dim == CIFAR_CNN_DIM, f"cifar_cnn D = {tr.spec.dim}")
        mix = "gossip_gather" if gossip == "sparse" else "gossip_matmul"
        for r in range(rounds):
            before = read_counts()
            profiled = r == rounds - 1
            sync(dev)
            with (torch.profiler.profile() if profiled
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()
                metrics = tr.run_round()
                loss, acc = float(metrics["loss"]), float(metrics["acc"])
                mass = float(tr.state.w.sum())
                sync(dev)
                wall = time.perf_counter() - t
            used = {k: v - before[k] for k, v in read_counts().items()}
            print(f"  {gossip} round {r}: loss {loss:.4f} acc {acc:.4f} "
                  f"mass {mass:.6f} wall {wall:.3f} s"
                  f"{' (profiled)' if profiled else ''} launches {used}")
            if profiled:
                print_profile(prof, wall)
            check(math.isfinite(loss), f"{gossip} round {r}: loss {loss}")
            check(abs(mass - n_clients) <= 1e-3,
                  f"{gossip} round {r}: push-sum mass {mass}")
            check(used["fused_update_bank"] == local_steps and used[mix] == 1,
                  f"{gossip} round {r}: launches {used}")
        tl, ta = tr.evaluate(test)
        print(f"  {gossip}: test loss {tl:.4f} acc {ta:.4f} after {rounds} "
              "rounds")
        check(math.isfinite(tl), f"{gossip}: test loss {tl}")
        del tr
    launches = read_counts()
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  peak device memory {peak:.2f} GiB")
    for k in ("fused_update_bank", "gossip_matmul", "gossip_gather"):
        check(launches[k] > 0, f"{k} was never launched on the main path")
    return launches


# -- phase 8: the scenario path at full width --------------------------------

def scenario_configs(tau=None) -> dict:
    """Phase 8's configurations: DFedSGPSM (or DFedAvgM for C) on the main
    path's model, data and topology, with the scenarios of the FL round."""
    from repro_torch.core import ChurnModel, LinkModel

    return {
        "A": dict(gossip="sparse", algo=dict(compressor="topk_ef",
                                             topk_ratio=0.05),
                  link=LinkModel(drop=0.2, delay=2),
                  churn=ChurnModel(fail_prob=0.05, recover_prob=0.5,
                                   permanent_frac=0.2, resurrect="cold")),
        "B": dict(gossip="dense", algo=dict(solver="proximal", prox_mu=0.01,
                                            compressor="int8_rows"),
                  link=LinkModel(event_threshold=tau or 1.0,
                                 event_decay=0.9)),
        "C": dict(name="dfedavgm", gossip="dense",
                  link=LinkModel(drop=0.2),
                  churn=ChurnModel(fail_prob=0.05, recover_prob=0.5)),
        "D sparse": dict(gossip="sparse", delta=8,
                         bank_dtype=torch.bfloat16),
        "D dense": dict(gossip="dense", delta=8, bank_dtype=torch.bfloat16),
    }


def scenario_trainer(dev, cdata, cfg: dict, n_clients: int = N_CLIENTS,
                     local_steps: int = 5, seed: int = 0):
    """An ``FLTrainer`` of one of :func:`scenario_configs`' compositions on
    the main path's cifar_cnn and kout k_out = 10 topology."""
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo
    from repro_torch.models.small import cifar_cnn

    model = cifar_cnn()
    topo = TopologyConfig(kind="kout", n_clients=n_clients, k_out=10)
    algo = make_algo(cfg.get("name", "dfedsgpsm"), local_steps=local_steps,
                     batch_size=32, lr=0.01, **cfg.get("algo", {}))
    kw = {k: cfg[k] for k in ("link", "churn", "delta", "bank_dtype")
          if cfg.get(k) is not None}
    return FLTrainer(model.loss, model.init, cdata, algo, topo, seed=seed,
                     gossip=cfg["gossip"], device=dev, **kw)


def scenario_path(dev, data, n_clients: int = N_CLIENTS, rounds: int = 3,
                  local_steps: int = 5, dim: int = CIFAR_CNN_DIM,
                  delta_dim: int = DELTA_DIM,
                  keep=("A", "D sparse")) -> tuple:
    """The rest of the FL round at full width: the main path's cifar_cnn,
    data and kout k_out = 10 topology under the configurations of
    :func:`scenario_configs`, ``rounds`` rounds each, through
    ``FLTrainer``.  B's event threshold is chosen here, on the card, from a
    first round's drift norms (about half the clients transmit).  Each
    round prints loss (over live clients), accuracy, push-sum mass, live
    share, comm_fraction, wall time and launches; the phase fails unless
    the loss is finite, the mass within 1e-3 of n, and every round launched
    the fused update once per local step and its mix once (B + 1 times
    under a delay bound B).  The last rounds of A and of D (sparse) are
    profiled.
    Then the compressors and the delayed mix are timed alone on A's bank.
    Returns the path's launch counts and the trainers named in ``keep``
    (phase 9 checkpoints them)."""
    cdata, _ = data

    def trainer(cfg):
        return scenario_trainer(dev, cdata, cfg, n_clients, local_steps)

    # B's threshold: the drift norms of a first round with any threshold
    # (the round's draws and updates do not depend on it).
    probe = spied(trainer(scenario_configs()["B"]))
    start = probe.state.params
    probe.run_round()
    Xc = probe.program.compressor.calls[0][1][1]
    tau = event_threshold(torch.sqrt(((Xc.float() - start.float()) ** 2)
                                     .sum(dim=1)).cpu())
    print(f"  B: event threshold {tau:.6g} (between two drift norms of a "
          "first round), decay 0.9 a round")
    del probe, start, Xc
    kept = {}
    zero_counts()  # the scenario path's counts start here
    for name, cfg in scenario_configs(tau).items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tr = trainer(cfg)
        want_dim = delta_dim if "delta" in cfg else dim
        check(tr.spec.dim == want_dim, f"{name}: bank width {tr.spec.dim}")
        link = cfg.get("link")
        mixes = link.delay + 1 if link is not None and link.delay else 1
        mix = "gossip_gather" if tr.program.sparse_mix else "gossip_matmul"
        other = "gossip_matmul" if mix == "gossip_gather" else "gossip_gather"
        for r in range(rounds):
            before = read_counts()
            profiled = r == rounds - 1 and name in ("A", "D sparse")
            sync(dev)
            with (torch.profiler.profile() if profiled
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()
                m = tr.run_round()
                m = {k: float(v) for k, v in m.items()}
                mass = m.get("w_mass", float(tr.state.w.sum()))
                sync(dev)
                wall = time.perf_counter() - t
            used = {k: v - before[k] for k, v in read_counts().items()}
            print(f"  {name} round {r}: loss {m['loss']:.4f} acc {m['acc']:.4f} "
                  f"w_mass {mass:.6f} live_frac {m.get('live_frac', 1.0):.2f} "
                  f"comm_fraction {m.get('comm_fraction', 1.0):.2f} wall "
                  f"{wall:.3f} s{' (profiled)' if profiled else ''} launches "
                  f"{ {k: v for k, v in used.items() if v} }")
            if profiled:
                print_profile(prof, wall, also=("topk", "sort", "radix"))
            check(math.isfinite(m["loss"]), f"{name} round {r}: loss {m['loss']}")
            check(abs(mass - n_clients) <= 1e-3,
                  f"{name} round {r}: push-sum mass {mass}")
            check(used["fused_update_bank"] == local_steps
                  and used[mix] == mixes and used[other] == 0,
                  f"{name} round {r}: launches {used}")
        if dev.type == "cuda":
            print(f"  {name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if name == "A":
            state = tr.state
        if name in keep:
            kept[name] = tr
        del tr
    launches = read_counts()
    compressor_costs(dev, state)
    return launches, kept


def compressor_costs(dev, state, iters: int = 5) -> None:
    """The scenario path's costs beside the plain round's mix, on A's last
    bank (100 x 1,756,426 f32): top-k with error feedback (k = 5% of D),
    int8 row quantization, and the delayed mix (three slices, three gathers,
    the buffer shift) against one gather of the same operator."""
    from repro_torch.core import pushsum, stages, topology

    X, n = state.params, state.params.shape[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    nl = topology.sample_kout_neighbors(gen, n, 10)
    topk = stages.TopKEFCompressor(0.05)
    int8 = stages.Int8RowCompressor()
    delayed = stages.DelayedPushSumMixer(delay=2)
    link = stages.LinkState(gen, **delayed.link_buffers(X))
    d = stages.draw_delays(gen, nl, 2)
    w = torch.ones(n, device=dev)
    costs = {
        "topk_ef apply": lambda: topk.apply(state.comp, X),
        "int8_rows apply": lambda: int8.apply((), X),
        "delayed mix_round (delay 2)": lambda: delayed.mix_round(
            nl, X, w, link, d, X),
        "one gather (no delay)": lambda: pushsum.gossip_bank(nl, X),
    }
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"  costs on A's bank ({n} x {X.shape[1]:,} {str(X.dtype)[6:]}), "
          f"{clock}: " + "; ".join(
        f"{k} {timed_ms(fn, dev, iters, warmup=1):.3f} ms"
        for k, fn in costs.items()))


# -- phase 6: dense against sparse mix ----------------------------------------

K_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def rule_losses(times: dict, floor, density: float) -> dict:
    """For each mix, the worst slowdown against the faster mix over the
    timed (n, k_max) pairs that the rule "sparse iff n >= floor and k_max
    <= density * n" sends to it, with that pair (``floor`` None: never
    sparse)."""
    worst = {"sparse": (1.0, None), "dense": (1.0, None)}
    for (n, k), (dense, sparse) in times.items():
        use = floor is not None and n >= floor and k <= density * n
        mix, t = ("sparse", sparse) if use else ("dense", dense)
        if t / min(dense, sparse) > worst[mix][0]:
            worst[mix] = (t / min(dense, sparse), (n, k))
    return worst


# A pair counts as lost by the gather only if its median time exceeds the
# dense mix's by more than this share, so that a near tie does not move
# the rule with a run's noise.  On an H100 the pairs read either at most
# 1.050x (the widest spread of a pair over its repeats: 0.031) or at
# least 1.19x; phase 6 prints the median nearest the limit.
CROSSOVER_MARGIN = 0.10
# Device cycles (about 5 ms on an H100) the card spins before a timed
# batch, so the host has queued every call of the batch when it starts.
QUEUE_CYCLES = 10_000_000


def queued_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    queued behind a device spin, so the calls run back to back and the
    host's launch time (which differs between the two mixes' wrappers, and
    matches a small mix's own time) is not in it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def crossover(dev, d: int, ns=(4, 8, 16, 32, 64, 128), iters: int = 10,
              repeats: int = 5):
    """Time the dense mix against the gather at every n in ``ns`` and every
    k_max of ``K_LADDER`` up to n, at the main path's D: each pair
    ``repeats`` times, the two mixes side by side in alternating order,
    each by :func:`queued_ms`, and the median of each kept.  The density
    rule's CUDA constants follow from the medians: the density limit is the
    largest timed k_max/n at and below which the gather lost no timed pair
    by more than ``CROSSOVER_MARGIN``, and the floor the least n that
    k_max = 1 passes.  So the rule sends no timed pair to a gather that is
    clearly slower: a gather pick loses without bound as k_max grows, a
    dense pick at most the dense kernel's own time."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2)
    times = {}  # (n, k_max) -> (median dense ms, median sparse ms)
    spread = (0.0, None)  # the widest sparse/dense ratio range of a pair
    for n in ns:
        X = torch.randn(n, d, generator=gen, device=dev)
        P = torch.rand(n, n, generator=gen, device=dev)
        P = P / P.sum(0)
        cells = []
        for k in (k for k in K_LADDER if k <= n):
            # k distinct senders per receiver: the time depends on neither
            # the weights nor which rows they are.
            idx = torch.rand(n, n, generator=gen, device=dev).argsort(
                dim=1)[:, :k].to(torch.int32).contiguous()
            wgt = torch.full((n, k), 1.0 / k, device=dev)
            mixes = (lambda: ops.gossip_mix(P, X),
                     lambda: ops.gossip_mix_sparse(idx, wgt, X))
            runs = []  # (dense, sparse) per repeat
            for r in range(repeats):
                order = (0, 1) if r % 2 == 0 else (1, 0)
                ms = {i: queued_ms(mixes[i], iters) for i in order}
                runs.append((ms[0], ms[1]))
            dense, sparse = (statistics.median(col) for col in zip(*runs))
            ratios = [s / dd for dd, s in runs]
            if max(ratios) - min(ratios) > spread[0]:
                spread = (max(ratios) - min(ratios), (n, k))
            times[n, k] = (dense, sparse)
            cells.append(f"{k}:{dense:.4f}/{sparse:.4f}({sparse / dense:.3f})")
        print(f"  n={n} D={d}, medians of {repeats}: dense/sparse ms by "
              f"k_max (sparse/dense): {' '.join(cells)}")
        del X
    limit = 1 + CROSSOVER_MARGIN
    near = min(times, key=lambda nk: abs(times[nk][1] / times[nk][0] - limit))
    print(f"  widest sparse/dense range over the {repeats} repeats of a pair: "
          f"{spread[0]:.3f} at (n, k_max) = {spread[1]}; a pair is lost "
          f"beyond {limit:.2f}x, and the median nearest that is "
          f"{times[near][1] / times[near][0]:.3f}x at {near}")
    density = max((r for r in sorted({k / n for n, k in times})
                   if all(sparse <= dense * limit
                          for (n, k), (dense, sparse) in times.items()
                          if k <= r * n)), default=None)
    floor = None if density is None else math.ceil(1 / density)
    shipped = (ops._SPARSE_GOSSIP_MIN_CLIENTS_CUDA,
               ops._SPARSE_GOSSIP_MAX_DENSITY_CUDA)
    for what, (f, r) in (("from these times", (floor, density)),
                         ("ops constants", shipped)):
        rule = ("never sparse" if f is None
                else f"sparse iff n >= {f} and k_max <= {r:.6g} n")
        loss = ", ".join(
            f"{mix} picks {slow:.3f}x"
            + (f" at (n, k_max) = {at}" if at else "")
            for mix, (slow, at) in rule_losses(times, f, r).items())
        print(f"  {what}: {rule}; worst against the faster mix: {loss}")


# -- phase 7: serving gemma3-12b ----------------------------------------------

SERVE_ARGV = ["--arch", "gemma3-12b", "--no-smoke", "--batch", "4",
              "--prompt-len", "2048", "--new-tokens", "16", "--seed", "0"]


def serving_parity(dev, arch: str = "gemma3-12b", s: int = 100,
                   steps: int = 4, cfg=None) -> None:
    """Reduced ``arch`` in f32 (gemma3-12b: a 32-token window on layer 0, a
    global layer 1, hd = 64; the MoE models: 4 experts, top 2;
    llava-next-mistral-7b: 16 image embeddings before 84 tokens; xlstm-350m:
    1 mLSTM and 1 sLSTM block, whose prefill is recurrent; hymba-1.5b: 8
    meta tokens before the prompt, a global layer 0 and a 32-token window
    on layer 1), or ``cfg`` where given (a reduction of ``arch``): prefill
    of ``s`` positions and ``steps`` greedy decode steps on ``dev``
    against the same on the CPU, with the same parameters and batch.  Both sides compute in f32
    (TF32 off: a TF32 router would flip top-k choices) with sums in their
    own orders (cuBLAS, the flash kernel's online softmax), so the logits
    agree to 1e-4 of their magnitude; the greedy tokens must be equal.  For
    a MoE model it prints for how many tokens of any layer the two chose
    other experts.  The card launches the flash kernel once a GQA layer of
    the prefill (MLA and xLSTM have none)."""
    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.core.flat import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import get_model_api

    cfg = cfg or get_config(arch, smoke=True)
    api = get_model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, 2, s, seed=1)  # s positions, a prefix included
    runs = {}
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda t, d=d: t.to(d), params)
        before, sels = fa.launches, []
        with torch.no_grad(), recorded_routing(sels):
            logits, cache = api.prefill(
                p, {k: v.to(d) for k, v in batch.items()}, s + steps + 1)
            out, toks = [logits.cpu()], []
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            for i in range(steps):
                toks.append(tok.cpu())
                logits, cache = api.decode_step(p, cache, tok, s + i)
                out.append(logits.cpu())
                tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok.cpu())
        runs[d.type] = (out, toks, [x.cpu() for x in sels],
                        fa.launches - before)
    (want, want_toks, want_sel, _), (got, got_toks, got_sel, used) = (
        runs["cpu"], runs[dev.type])
    if cfg.n_experts:
        flips = sum(int((a.sort(-1).values != b.sort(-1).values)
                        .any(-1).sum()) for a, b in zip(got_sel, want_sel))
        print(f"  {arch}: {cfg.n_experts} experts top {cfg.top_k}, "
              f"{cfg.attn_type}; tokens routed to other experts on the card "
              f"than on the CPU: {flips} (of "
              f"{sum(x[..., 0].numel() for x in want_sel)} over the layers "
              "and steps)")
    for i, (g, w) in enumerate(zip(got, want)):
        e, tol = max_err(g, w), 1e-4 * float(w.abs().max())
        print(f"  {'prefill' if i == 0 else f'decode step {i}'} logits "
              f"{tuple(g.shape)}: max|err| {e:.3e} (tolerance {tol:.3e})")
        check(e <= tol, f"{arch}: card and CPU logits disagree ({i})")
    check(all(torch.equal(a, b) for a, b in zip(got_toks, want_toks)),
          f"{arch}: card and CPU greedy tokens differ")
    flash = (cfg.n_layers if cfg.attn_type == "gqa"
             and cfg.block_kind != "xlstm" else 0)
    print(f"  greedy tokens equal; flash launches on the card: {used} "
          f"(one per GQA layer of the prefill: {flash})")
    if dev.type == "cuda":
        check(used == flash, f"{arch}: flash launches {used}")


def serving(dev, argv=SERVE_ARGV) -> dict:
    """The serving main path through its entry point, ``serve.main``: full
    width gemma3-12b in bf16, parameters drawn on the card, 4 requests of
    2048 prompt tokens, then greedy decode (16 new tokens: one from the
    prefill and 15 decode steps, cache of 2048 + 16).  Then, on the model,
    parameters and prompts that run built: a second, steady
    ``serve.generate``, one profiled prefill and one profiled decode step,
    and :func:`decode_check` of what the first run decoded."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step

    args = serve.build_parser().parse_args(argv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the serving path's counts start here
    t = time.perf_counter()
    rec = serve.main(argv + ["--device", dev.type])
    wall = time.perf_counter() - t
    launches = read_counts()
    api, params, batch = rec["api"], rec["params"], rec["batch"]
    cfg, steps = api.cfg, rec["steps"]
    print(f"  {cfg.name}: {api.num_params() / 1e9:.2f} B parameters, "
          f"{cfg.n_layers} layers, windows "
          f"{sorted(set(cfg.window_for_layer(i) for i in range(cfg.n_layers)))}")
    print(f"  serve.main {wall:.1f} s (parameter init included); prefill "
          f"{rec['prefill_s']:.4f} s (first call); decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{args.batch * steps / rec['decode_s']:.1f} tokens/s; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(rec["finite"], "a prefill or decode logit is not finite")
    check(tuple(rec["tokens"].shape) == (args.batch, args.new_tokens),
          f"tokens {tuple(rec['tokens'].shape)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash launches per prefill {launches['flash_attention']}, "
          f"expected {cfg.n_layers}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"the FL kernels ran on the serving path: {launches}")

    warm = serve.generate(api, params, batch, args.new_tokens)
    print(f"  steady serve.generate: prefill {warm['prefill_s']:.4f} s; decode "
          f"{1e3 * warm['decode_s'] / steps:.2f} ms/step, "
          f"{args.batch * steps / warm['decode_s']:.1f} tokens/s")
    del warm
    with torch.no_grad():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            logits, cache = api.prefill(params, batch,
                                        args.prompt_len + args.new_tokens)
            sync(dev)
            wall = time.perf_counter() - t
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        del logits
        print(f"  profiled prefill {wall:.4f} s:")
        print_split(prof, wall, "prefill")
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            make_serve_step(api)(params, cache, tok, args.prompt_len)
            sync(dev)
            wall = time.perf_counter() - t
        del cache
    print(f"  profiled decode step {1e3 * wall:.2f} ms:")
    print_split(prof, wall, "decode step")
    decode_check(api, params, batch, rec)
    return launches


# The decode check's mutants, each a decode fault the check must see.
MUTANTS = {"window": "with the window left open at decode",
           "layer": "with each decode step on the layer before's cache",
           "prefix": "with decode positions that leave out the image prefix",
           "meta": "with decode positions that leave out the meta tokens"}


def decode_check(api, params, batch, rec, mutant="window",
                 pin=contextlib.nullcontext, rel=None) -> float:
    """Holds what ``serve.generate`` decoded against ``forward`` on the
    prompt extended by the decoded tokens: the logits each new token was
    picked from must be the forward's at positions P+S-1 .. P+S+N-2, P the
    vlm's image prefix (0 without one).  At full width gemma3-12b's decode
    steps run at positions 2048 .. 2062, where the local layers'
    1024-token window closes keys, so this covers the decode attention's
    mask, its reads of the cache and every step's cache write.  The forward
    runs inside ``pin()`` (the MoE models pin its routing to the served
    path's: :func:`moe_decode_check`).

    Tolerance: in f32, 1e-4 of the logits' magnitude (as the parity step);
    in bf16, 2^-4 of it: the two sides round every layer's bf16 activations
    from sums taken in their own orders (the flash kernel against the plain
    decode attention, cuBLAS at M = B*S against M = B).  ``rel`` replaces
    that fraction (hymba's f32 check, :func:`hymba_serving`).

    To show that the check sees a fault there, the decode steps run once
    more, from a fresh prefill, with a fault that must miss the tolerance:
    ``mutant="window"`` leaves the window open at decode (the same model
    but a window as long as the cache, so the same rope thetas);
    ``"layer"``, for a model without a window, gives each decode step the
    cache of the layer before its own (the stacked cache's layer index off
    by one); ``"prefix"``, for the vlm, decodes at S + i, leaving out the
    image prefix (the reference launcher's class of bug); ``"meta"``, for
    hymba, decodes without the meta tokens' offset (the cache written and
    read, and the rope turned, n_meta positions early); None skips it.
    Returns the tolerance."""
    import dataclasses

    from repro_torch.models.registry import get_model_api

    cfg, prompt = api.cfg, batch["tokens"]
    got = rec["logits"]
    s, n = prompt.shape[1], got.shape[1]
    n_prefix = batch["image_feats"].shape[1] if "image_feats" in batch else 0
    new = rec["tokens"][:, :n - 1].to(prompt.device, prompt.dtype)
    with torch.no_grad():
        with pin():
            want = api.forward(params, dict(
                batch, tokens=torch.cat([prompt, new], 1)))[0]
        # frees the other positions' logits
        want = want[:, n_prefix + s - 1:].clone()
        if mutant:
            step_api, pos0 = api, n_prefix + s
            logits, cache = api.prefill(params, batch, n_prefix + s + n)
            wrong = [logits[:, -1].clone()]
            del logits
            if mutant == "window":
                step_api = get_model_api(dataclasses.replace(
                    cfg, sliding_window=s + n))
            elif mutant == "prefix":
                pos0 = s
            elif mutant == "meta":
                pos0 = s - cfg.n_meta_tokens
            else:
                cache = {k: v.roll(1, 0) for k, v in cache.items()}
            for i in range(n - 1):
                wrong.append(step_api.decode_step(params, cache, new[:, i],
                                                  pos0 + i)[0])
            del cache
    scale = float(want.float().abs().max())
    if rel is None:
        rel = 1e-4 if cfg.dtype == torch.float32 else 2.0 ** -4
    tol = rel * scale
    err = max_err(got, want)
    print(f"  decode check: {n} positions from {n_prefix + s - 1}, logits "
          f"{tuple(got.shape)}"
          f" against forward on the extended prompt: max|err| {err:.4e} "
          f"(tolerance {tol:.4e}, {tol / scale:.3g} of max|logit| "
          f"{scale:.4e})")
    check(err <= tol, "decode disagrees with forward on the extended prompt")
    if mutant:
        err_mut = max_err(torch.stack(wrong, 1), want)
        print(f"  {MUTANTS[mutant]}: {err_mut:.4e}")
        check(err_mut > tol, f"the decode check does not see its mutant "
                             f"({MUTANTS[mutant]})")
    return tol


def kind_split(prof, spans=()) -> dict:
    """Device time (ms) by kind over a profile, from the device's own
    timeline: a kernel that runs inside the device-side span of a
    ``record_function`` range named in ``spans`` goes to that range's
    kind; any other to the flash kernel, the matmuls (cuBLAS / CUTLASS
    kernels) or the rest by its name.  (An operator's list of launched
    kernels would count a kernel once for every enclosing operator that
    shares its correlation id.)"""
    from torch.autograd import DeviceType

    overhead = ("Buffer Flush", "Activity Buffer Request")
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name not in overhead]
    windows = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if e.name in spans]
    split = {"flash": 0.0, **{k: 0.0 for k in spans}, "matmuls": 0.0,
             "rest": 0.0}
    for e in events:
        if e.name in spans:
            continue
        start, end = e.time_range.start, e.time_range.end
        kind = next((k for k, a, b in windows if a <= start and end <= b),
                    None)
        name = e.name.lower()
        if kind is None:
            kind = ("flash" if "flash_attention_kernel" in name else
                    "matmuls" if any(t in name for t in (
                        "gemm", "nvjet", "cutlass", "xmma", "sm90_",
                        "cublas")) else "rest")
        split[kind] += (end - start) / 1e3
    return split


def print_split(prof, wall_s: float, what: str, spans=()) -> None:
    """``print_profile``, then the device time by kind
    (:func:`kind_split`): the flash kernel, each range of ``spans``, the
    matmuls and the rest."""
    print_profile(prof, wall_s, top=8, skip=tuple(spans))
    split = kind_split(prof, spans)
    total = sum(split.values())
    print(f"  {what} device time by kind: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / max(total, 1e-9):.1f}%)"
        for k, v in split.items()))


# -- phase 9: checkpoints at full width ----------------------------------------

def state_arrays(st) -> dict:
    """Every tensor of a port ``FLState``, by checkpoint name."""
    out = {"params": st.params, "mom": st.mom, "w": st.w,
           "losses": st.losses, "comp": st.comp}
    if st.link:
        out.update({f"link_{f}": getattr(st.link, f)
                    for f in ("bufx", "bufw", "last")})
    if st.churn:
        out.update(churn_live=st.churn.live, churn_tpl=st.churn.tpl)
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def state_streams(st) -> dict:
    out = {"key": st.key}
    if st.link:
        out["link_key"] = st.link.key
    if st.churn:
        out["churn_key"] = st.churn.key
    return out


def checkpoint_phase(dev, data, trainers=None, rounds: int = 1,
                     local_steps: int = 5) -> dict:
    """``FLTrainer.save`` / ``restore`` at full width: phase 8's A trainer
    (top-k EF, drops, delay 2, cold churn: it carries ``comp``, ``link``
    and ``churn``) and its D sparse trainer (the bf16 rank-8 delta bank:
    format v3 with ``__base__``).  Each saves to a temporary directory and
    restores into a fresh trainer of its composition (seed 1); every array
    and every generator state must be equal bit for bit.  Then one round
    from each, with ``cudnn.deterministic`` set for the phase, must give
    the same bank, ``w`` and momentum bit for bit.  A's file restored into
    its composition without the link scenario must raise.  Without
    ``trainers``, they are built here and run ``rounds`` rounds."""
    import shutil
    import tempfile

    import numpy as np

    cdata, _ = data
    cfgs = scenario_configs()
    if trainers is None:
        trainers = {}
        for name in ("A", "D sparse"):
            trainers[name] = scenario_trainer(dev, cdata, cfgs[name],
                                              local_steps=local_steps)
            for _ in range(rounds):
                trainers[name].run_round()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    zero_counts()  # phase 9's counts start here
    try:
        for name in ("A", "D sparse"):
            tr = trainers[name]
            tmp = tempfile.mkdtemp(prefix="ckpt_")
            try:
                sync(dev)
                t = time.perf_counter()
                path = tr.save(tmp, step=tr.state.round)
                save_s = time.perf_counter() - t
                nbytes = os.path.getsize(path)
                with np.load(path) as f:
                    members = set(f.files)
                fresh = scenario_trainer(dev, cdata, cfgs[name],
                                         local_steps=local_steps, seed=1)
                sync(dev)
                t = time.perf_counter()
                st = fresh.restore(path)
                sync(dev)
                restore_s = time.perf_counter() - t
                want, got = state_arrays(tr.state), state_arrays(st)
                check(set(want) == set(got),
                      f"{name}: restored fields {sorted(got)} != {sorted(want)}")
                for k in want:
                    check(want[k].dtype == got[k].dtype
                          and want[k].device == got[k].device
                          and torch.equal(want[k], got[k]),
                          f"{name}: restored {k} differs")
                check(st.round == tr.state.round, f"{name}: round")
                gw, gg = state_streams(tr.state), state_streams(st)
                check(set(gw) == set(gg), f"{name}: streams {sorted(gg)}")
                for k in gw:
                    check(torch.equal(gw[k].get_state(), gg[k].get_state())
                          and gw[k].initial_seed() == gg[k].initial_seed(),
                          f"{name}: restored stream {k} differs")
                print(f"  {name}: saved {nbytes / 1e9:.3f} GB "
                      f"({len(members)} members) in {save_s:.3f} s, restored "
                      f"in {restore_s:.3f} s; {len(want)} arrays "
                      f"({', '.join(sorted(want))}) and {len(gw)} generator "
                      f"states ({', '.join(sorted(gw))}) equal bit for bit")
                if name == "D sparse":
                    check("__base__" in members,
                          "the delta bank's checkpoint has no __base__")
                ma, mb = tr.run_round(), fresh.run_round()
                sync(dev)
                for k in ("params", "w", "mom"):
                    a, b = getattr(tr.state, k), getattr(fresh.state, k)
                    check(torch.equal(a, b),
                          f"{name}: the round after restore differs in {k} "
                          f"(max|diff| {max_err(a, b):.3e})")
                print(f"  {name}: one round from each: loss "
                      f"{float(ma['loss']):.6f} and {float(mb['loss']):.6f}; "
                      "bank, w and momentum equal bit for bit")
                del fresh, st
                if name == "A":
                    other = scenario_trainer(dev, cdata,
                                             dict(cfgs[name], link=None),
                                             local_steps=local_steps)
                    try:
                        other.restore(path)
                    except ValueError as e:
                        print(f"  A's file into A without its link scenario "
                              f"raises: {str(e)[:100]}...")
                    else:
                        check(False, "a link carry restored into a link-free "
                                     "composition")
                    del other
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        torch.backends.cudnn.deterministic = prev
    return read_counts()


# -- phase 10: the paged store -------------------------------------------------

# README "Scenario: virtual client population" and round_bench.paged_bench's
# defaults, the population cut from 4096 to 2048 clients (8 chunks of 256
# rows): the phase's time is the store's host I/O, about half of it gone,
# which keeps the whole script inside its time; the model is the paper's
# MNIST 2NN (784-200-200-10).
PAGED_N, PAGED_K_ACTIVE, PAGED_K_OUT = 2048, 256, 4
MNIST_2NN_DIM = 199_210


def mnist_population(dev, n: int = PAGED_N, n_train: int = 60_000,
                     per_client: int = 32):
    """Synthetic MNIST split by Dirichlet(0.3) over ``n`` clients."""
    from repro_torch.data.dirichlet import dirichlet_partition, stack_client_data
    from repro_torch.data.synthetic import make_dataset

    t0 = time.perf_counter()
    train, _ = make_dataset("mnist", n_train, 100, seed=0)
    parts = dirichlet_partition(train["y"], n, alpha=0.3, seed=0)
    cdata = stack_client_data(train, parts, pad_to=per_client)
    print(f"  data: {n_train} synthetic MNIST images, Dirichlet(0.3) over {n} "
          f"clients, {per_client} rows each "
          f"({time.perf_counter() - t0:.1f} s to make)")
    return {k: torch.as_tensor(v, device=dev) for k, v in cdata.items()}


def paged_kernel_times(dev, k_active: int, c_max: int, d: int, slots: int,
                       iters: int = 10) -> None:
    """The update at (k_active, D) and the gather at (c_max, D) with
    ``slots`` slots, the paged round's shapes: against their plain versions
    (bit for bit) and timed beside their byte bounds."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import gossip_gather as gg

    gen = torch.Generator(device=dev).manual_seed(4)
    X, V, G = (torch.randn(k_active, d, generator=gen, device=dev)
               for _ in range(3))
    w = torch.rand(k_active, generator=gen, device=dev) + 0.5
    e = max(max_err(a, b) for a, b in zip(
        fu.fused_update_bank(X, V, G, 0.9, 0.1, w),
        fu.fused_update_bank_plain(X, V, G, 0.9, 0.1, w)))
    check(e == 0.0, f"fused_update_bank disagrees at ({k_active}, {d})")
    b, by = update_cost(k_active, d, 4).bound_ms()
    ms = timed_ms(lambda: fu.fused_update_bank(X, V, G, 0.9, 0.1, w), dev,
                  iters)
    plain = timed_ms(lambda: fu.fused_update_bank_plain(X, V, G, 0.9, 0.1, w),
                     dev, iters)
    print(f"  fused_update_bank f32 n={k_active} D={d}: max|err| {e:.1e} "
          f"(bitwise); {ms:.4f} ms, bound {b:.4f} ms ({by}), "
          f"{100 * b / ms:.1f}% of it; plain {plain:.4f} ms")
    del X, V, G
    X = torch.randn(c_max, d, generator=gen, device=dev)
    idx = torch.randint(0, c_max, (c_max, slots), generator=gen, device=dev,
                        dtype=torch.int32)
    wgt = torch.rand(c_max, slots, generator=gen, device=dev)
    e = max_err(gg.gossip_gather(idx, wgt, X),
                gg.gossip_gather_plain(idx, wgt, X))
    check(e == 0.0, f"gossip_gather disagrees at ({c_max}, {d}, {slots})")
    b, by = gather_cost(c_max, c_max, slots, d, 4).bound_ms()
    ms = timed_ms(lambda: gg.gossip_gather(idx, wgt, X), dev, iters)
    plain = timed_ms(lambda: gg.gossip_gather_plain(idx, wgt, X), dev, iters)
    lib = timed_ms(lambda: torch.einsum("nk,nkd->nd", wgt, X[idx.long()]),
                   dev, max(iters // 5, 1))
    print(f"  gossip_gather f32 n={c_max} D={d} k_max={slots} "
          f"({gather_path(dev, c_max, slots, torch.float32)}): max|err| "
          f"{e:.1e} (bitwise); {ms:.4f} ms, bound {b:.4f} ms ({by}), "
          f"{100 * b / ms:.1f}% of it; plain {plain:.4f} ms; einsum over "
          f"X[idx] {lib:.4f} ms")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def corrupt_clean_chunk(store, n: int):
    """Make the store's last chunk clean and corrupt: write its template
    rows and record it as never holding trained data, then flip one byte
    of its file.  Returns the chunk's first row and file name."""
    import numpy as np

    start = (n - 1) // store.rows_per_chunk * store.rows_per_chunk
    ids = np.arange(start, n)
    store.write_rows(ids, store.read_rows(ids))
    store._chunks[start]["dirty"].clear()
    store.update_meta()
    fname = store._chunks[start]["file"]
    with open(os.path.join(store.path, fname), "r+b") as f:
        f.seek(4096)
        byte = f.read(1)
        f.seek(4096)
        f.write(bytes([byte[0] ^ 0x10]))
    return start, fname


def paged_phase(dev, n: int = PAGED_N, k_active: int = PAGED_K_ACTIVE,
                k_out: int = PAGED_K_OUT, rounds: int = 1,
                local_steps: int = 5, per_client: int = 32,
                dim: int = MNIST_2NN_DIM) -> dict:
    """``FLTrainer(paged=True)`` at the README's setting (n cut to
    :data:`PAGED_N`): n clients on disk,
    k_active a round, kout k_out, mnist_2nn (DFedSGPSM, 5 local steps).
    Before the cold round the store's last chunk is made clean and
    corrupted: the cold round must rebuild it from the template and never
    consume it.  One cold round and ``rounds`` timed rounds, each with its
    launches (5 updates at (k_active, D) and 1 gather at (c_max, D), k_out
    + 1 slots), closure mass error, wall time and pager counters; the
    write-back's drain after them, and the time a round including it;
    store-wide mass; then ``save()``, and a reopen of the saved store
    under a ``ChurnModel`` and a ``FaultInjector`` (a transient EIO on
    every file's first read): the round, its generator and the last
    round's rows bit for bit, a round after the reads that retried the
    EIOs, with the mass exact, and a flipped byte in a chunk of
    trained rows, which a read must refuse.  The phase's wall time by step
    closes it.  One timed round and one under churn and faults keep the
    whole script well inside its time limit: the write-back's drain after
    the rounds, host disk I/O, took most of the phase, and grows with the
    rounds run."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import ChurnModel, FLTrainer, TopologyConfig, make_algo
    from repro_torch.models.small import mnist_2nn
    from repro_torch.store import FaultInjector, StoreCorruptionError

    spent = {}
    t_step = time.perf_counter()

    def lap(what):
        nonlocal t_step
        now = time.perf_counter()
        spent[what] = spent.get(what, 0.0) + now - t_step
        t_step = now

    cdata = mnist_population(dev, n, per_client=per_client)
    model = mnist_2nn()
    # lr 0.01: at the default 0.1 the loss grew past 1e4 by the third
    # round on an H100, and it grows alike in the reference at these
    # ratios (tests/test_torch_paged_growth.py): a client that sent mass
    # as a cold in-neighbour comes back active with a small push-sum
    # weight w, and steps lr / w in de-biased terms.
    algo = make_algo("dfedsgpsm", local_steps=local_steps, batch_size=32,
                     lr=0.01)
    topo = TopologyConfig(kind="kout", n_clients=n, k_out=k_out)
    c_max = k_active * (k_out + 1)
    lap("data")
    paged_kernel_times(dev, k_active, c_max, dim, k_out + 1)
    lap("kernel checks")
    work = tempfile.mkdtemp(prefix="paged_")
    store_dir = os.path.join(work, "store")
    zero_counts()  # phase 10's counts start here

    def trainer(**kw):
        return FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                         paged=True, store_dir=store_dir, k_active=k_active,
                         device=dev, **kw)

    def run(tr, r, what):
        before, stats0 = read_counts(), tr.runner.stats.as_dict()
        sync(dev)
        t = time.perf_counter()
        with kernel_shapes() as shapes:
            rec = tr.run_round()
            sync(dev)
        wall = time.perf_counter() - t
        check(set(shapes["fused_update_bank"]) == {((k_active, dim),) * 3
                                                   + ((k_active,),)}
              and shapes["gossip_gather"] == [((c_max, k_out + 1),) * 2
                                              + ((c_max, dim),)],
              f"{what} round {r}: kernel shapes {shapes}")
        used = {k: v - before[k] for k, v in read_counts().items()}
        st = tr.runner.stats.as_dict()
        faulted = st["rows_faulted"] - stats0["rows_faulted"]
        if r == 0:
            print(f"  {what}: each round's updates take (X, V, G, w) of "
                  f"shapes {shapes['fused_update_bank'][0]}, its gather "
                  f"(idx, wgt, X) {shapes['gossip_gather'][0]}")
        print(f"  {what} round {r}: loss {rec['loss']:.4f} acc {rec['acc']:.4f}"
              f" closure rows {int(rec['rows_resident'])} closure mass error "
              f"{rec['w_mass_closure_err']:.3e} wall {wall:.3f} s; rows "
              f"faulted {faulted}, carried "
              f"{st['rows_carried'] - stats0['rows_carried']}, prefetched "
              f"{st['rows_prefetched'] - stats0['rows_prefetched']}, cache "
              f"{st['rows_cache_hit'] - stats0['rows_cache_hit']}; chunks "
              f"written so far {st['chunks_written']}; launches "
              f"{ {k: v for k, v in used.items() if v} }")
        check(math.isfinite(rec["loss"]), f"{what} round {r}: loss")
        check(rec["w_mass_closure_err"] <= 1e-3,
              f"{what} round {r}: closure mass error")
        check(used["fused_update_bank"] == local_steps
              and used["gossip_gather"] == 1 and used["gossip_matmul"] == 0,
              f"{what} round {r}: launches {used}")
        return wall

    def drain(runner, walls, what):
        """Time the write-back's drain; print the rounds' time with it."""
        t = time.perf_counter()
        runner.flush()
        d = time.perf_counter() - t
        print(f"  {what}: {len(walls)} rounds {sum(walls):.3f} s "
              f"({', '.join(f'{x:.3f}' for x in walls)}), then the "
              f"write-back's drain {d:.3f} s: {(sum(walls) + d) / len(walls):.3f}"
              f" s a round including it; {runner.store.chunks_written} "
              f"chunks written in all")
        return d

    try:
        tr = trainer()
        r = tr.runner
        store = r.store
        check(tr.spec.dim == dim, f"mnist_2nn D = {tr.spec.dim}")
        check(r.resident_rows == c_max and r.staging_rows == 2 * c_max,
              f"resident {r.resident_rows}, staging {r.staging_rows}")
        row_b = store.row_nbytes
        print(f"  n={n} k_active={k_active} kout k_out={k_out}: c_max "
              f"{c_max} resident rows, {2 * c_max} staging rows; a row is "
              f"{row_b / 1e6:.3f} MB, so {c_max * row_b / 1e9:.3f} GB "
              f"resident of a {n * row_b / 1e9:.3f} GB population in "
              f"{-(-n // store.rows_per_chunk)} chunks of "
              f"{store.rows_per_chunk} rows")
        start, fname = corrupt_clean_chunk(store, n)
        lap("clean chunk written and corrupted")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        walls = [run(tr, 0, "cold")]
        check(store.corrupt_chunks == 1 and store.rebuilt_rows == n - start,
              f"the corrupted clean chunk was not rebuilt "
              f"({store.corrupt_chunks}, {store.rebuilt_rows})")
        check(os.path.exists(os.path.join(store.path, "quarantine", fname)),
              "the corrupted chunk was not quarantined")
        print(f"  the corrupted clean chunk (rows {start}..{n - 1}): "
              f"quarantined and {store.rebuilt_rows} rows rebuilt from the "
              f"template in the cold round")
        walls += [run(tr, i + 1, "timed") for i in range(rounds)]
        lap(f"cold and {rounds} timed rounds")
        drain(r, walls, "cold and timed")
        lap("the write-back's drain after them")
        mass = r.total_mass()
        stats = r.stats.as_dict()
        print(f"  store-wide mass {mass:.6f} (n = {n}); pager: "
              f"{stats['rows_faulted_per_round']:.1f} rows faulted a round, "
              f"hit rate {stats['prefetch_hit_rate']:.3f}, prefetch overlap "
              f"{stats['prefetch_overlap_s']:.3f} s, wait "
              f"{stats['prefetch_wait_s']:.3f} s; store on disk "
              f"{dir_bytes(store.path) / 1e9:.3f} GB")
        if dev.type == "cuda":
            print(f"  peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(abs(mass - n) <= 1e-3, f"store-wide mass {mass}")
        lap("store-wide mass")
        tr.save()
        lap("save")
        print(f"  save (manifest commit) {spent['save']:.3f} s; committed "
              f"store {dir_bytes(store_dir) / 1e9:.3f} GB")
        saved_round, saved_key = r.round_index, r._key.get_state()
        last = np.asarray(sorted(r._carry))
        want = {k: np.stack([r._carry[int(g)][k] for g in last])
                for k in r._carry[int(last[0])]}
        r.close()
        del tr, r, store

        fi = FaultInjector(seed=0, eio_prob=1.0, eio_max_per_path=1)
        chaos = trainer(faults=fi, churn=ChurnModel(
            fail_prob=0.05, recover_prob=0.5, resurrect="cold"))
        rr = chaos.runner
        store = rr.store
        check(rr.round_index == saved_round, "reopened round")
        check(torch.equal(rr._key.get_state(), saved_key),
              "reopened round generator")
        got = store.read_rows(last)
        for k, v in want.items():
            check(np.array_equal(got[k], v),
                  f"reopened rows of the last round differ in {k}")
        chunks = set((last // store.rows_per_chunk).tolist())
        check(len(chunks) == -(-n // store.rows_per_chunk),
              f"the last round's rows lie in {len(chunks)} chunks only")
        lap("reopen and read back")
        print(f"  reopened at round {rr.round_index} under churn and faults:"
              f" the last round's {len(last)} rows equal bit for bit, read "
              f"from all {len(chunks)} chunks against their committed "
              f"checksums ({spent['reopen and read back']:.1f} s, "
              f"{store.io_retries} reads retried)")
        walls = [run(chaos, 0, "churn + faults")]
        lap("churn + faults rounds")
        drain(rr, walls, "churn + faults")
        lap("the write-back's drain after those")
        mass = rr.total_mass()
        print(f"  churn + faults: {fi.faults_injected} faults injected, "
              f"{store.io_retries} reads retried ({store.backoff_seconds:.3f} "
              f"s of backoff); store-wide mass {mass:.6f}")
        check(store.io_retries >= 1, "no transient read fault was retried")
        check(abs(mass - n) <= 1e-3, f"churn + faults: mass {mass}")
        rr.close()
        del chaos, rr
        # A chunk of trained rows with one flipped byte: a read must
        # refuse it, never rebuild or consume it.
        dirty = next(s for s, e in sorted(store._chunks.items())
                     if e["dirty"] and e["crc"] is not None)
        with open(os.path.join(store.path, store._chunks[dirty]["file"]),
                  "r+b") as f:
            f.seek(4096)
            byte = f.read(1)
            f.seek(4096)
            f.write(bytes([byte[0] ^ 0x10]))
        try:
            store.read_rows([dirty])
            refused = False
        except StoreCorruptionError:
            refused = True
        check(refused, "a corrupted chunk of trained rows was read")
        print(f"  a flipped byte in the chunk of rows {dirty}.. (trained "
              "rows): the read refused it")
        lap("store-wide mass and the corrupted trained chunk")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("close and remove the store")
    print(f"  phase 10's wall time, {sum(spent.values()):.1f} s: "
          + "; ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return read_counts()


# -- phase 11: personalized serving --------------------------------------------

PERSONAL_ARGV = ["--arch", "glm4-9b", "--no-smoke", "--clients", "2",
                 "--rank", "8", "--zero-clients", "1", "--prompt-len", "2048",
                 "--new-tokens", "16", "--seed", "0"]


def personalized(dev, argv=PERSONAL_ARGV) -> dict:
    """Personalized serving through ``serve.main --clients``: glm4-9b at
    full width in bf16, a rank-8 delta bank of 2 clients over the drawn
    base (lane 0 a zero row with w = 1, lane 1 a random row), one lane per
    client, prompts of 2048 tokens and 16 new tokens.  Lane 0 must match
    the dense ``serve.generate`` of the base on its prompt, and lane 1 the
    ``forward`` of its own expanded weights on its extended prompt, both
    within phase 7's decode tolerance (2^-4 of max|logit|); lane 0's
    logits held against lane 1's forward must miss it."""
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the personalized serving path's counts start here
    t = time.perf_counter()
    with kernel_shapes() as shapes:
        rec = serve.main(argv + ["--device", dev.type])
    wall = time.perf_counter() - t
    launches = read_counts()
    api, stacked, batch, spec = (rec["api"], rec["params"], rec["batch"],
                                 rec["spec"])
    cfg, steps, n = api.cfg, rec["steps"], args.clients
    print(f"  {cfg.name}: {api.num_params() / 1e9:.2f} B parameters, d_delta "
          f"{spec.dim} ({spec.dtype}); serve.main {wall:.1f} s (parameter "
          f"init included); expand {rec['expand_s']:.4f} s; prefill "
          f"{rec['prefill_s']:.4f} s; decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{n * steps / rec['decode_s']:.1f} tokens/s; launches {launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(rec["finite"], "a prefill or decode logit is not finite")
    check(tuple(rec["tokens"].shape) == (n, args.new_tokens),
          f"tokens {tuple(rec['tokens'].shape)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash launches per prefill {launches['flash_attention']}, "
          f"expected {cfg.n_layers}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"the FL kernels ran on the serving path: {launches}")
    hd, s_len = cfg.resolved_head_dim, args.prompt_len
    want_q = (n, cfg.n_heads, s_len, hd)
    want_kv = (n, cfg.n_kv_heads, s_len, hd)
    check(set(shapes["flash_attention"]) == {(want_q, want_kv, want_kv)},
          f"flash shapes {set(shapes['flash_attention'])}")
    print(f"  flash (q, k, v) shapes on every prefill layer: {want_q}, "
          f"{want_kv}, {want_kv}")

    dense = serve.generate(api, spec.base, {"tokens": batch["tokens"][:1]},
                           args.new_tokens)
    got, want = rec["logits"][0], dense["logits"][0]
    scale = float(want.float().abs().max())
    tol = (1e-4 if cfg.dtype == torch.float32 else 2.0 ** -4) * scale
    err = max_err(got, want)
    print(f"  lane 0 (zero row, w = 1) against the dense serve of the base: "
          f"max|err| {err:.4e} (tolerance {tol:.4e}); tokens "
          f"{'equal' if torch.equal(rec['tokens'][0], dense['tokens'][0]) else 'differ'}")
    check(err <= tol, "lane 0 disagrees with the dense serve of the base")
    del dense
    lane1 = tree_map(lambda x: x[1], stacked)
    one = {"logits": rec["logits"][1:2], "tokens": rec["tokens"][1:2]}
    tol1 = decode_check(api, lane1, {"tokens": batch["tokens"][1:2]}, one,
                        mutant=None)
    wrong = {"logits": rec["logits"][0:1], "tokens": rec["tokens"][1:2]}
    with torch.no_grad():
        s = batch["tokens"].shape[1]
        new = rec["tokens"][1:2, :-1].to(batch["tokens"].device,
                                          batch["tokens"].dtype)
        fwd = api.forward(lane1, {"tokens": torch.cat(
            [batch["tokens"][1:2], new], 1)})[0][:, s - 1:]
    err_mix = max_err(wrong["logits"], fwd)
    print(f"  lane 0's logits against lane 1's forward: {err_mix:.4e} (must "
          f"exceed {tol1:.4e})")
    check(err_mix > tol1, "the lane check does not tell the lanes apart")
    return launches


# -- phase 12: pods-as-clients training of glm4-9b -----------------------------

# glm4-9b's attention at train_4k's length: one sequence of 4096 tokens, 32
# query heads on 2 kv heads of hd 128 (GQA group 16), bf16, causal.
TRAIN_SHAPE = (1, 32, 2, 4096, 128)
# gemma3-12b's attention (hd 256, 16 on 8 heads), local and global layers.
GEMMA_SHAPE = (1, 16, 8, 2048, 256)
# gemma3-12b's attention in phase 20's training round: 1 x 4096 tokens a
# pod a step.
GEMMA_TRAIN_SHAPE = (1, 16, 8, 4096, 256)
TRAIN_LAYERS = 4  # glm4-9b's 40 layers cut to 4: 2 replicas fit the card
# Kernels a backward call launches at the training shape: D, dK / dV (a kv
# head's 16 query heads in 4 runs of 4), the runs' sum, dQ.
BWD_TRAIN_PASSES = 4
TRAIN_ARGV = ["--arch", "glm4-9b", "--rounds", "3", "--local-steps", "2",
              "--batch", "1", "--seq", "4096"]
# hubert-xlarge's attention in phase 16's training round: 2 clips of 1500
# frames a pod a step, 16 query heads on 16 kv heads of hd 80, non-causal.
HUBERT_TRAIN_SHAPE = (2, 16, 16, 1500, 80)
# llava-next-mistral-7b's attention in phase 16's training round: 1 row of
# 5760 positions a pod a step, 32 query heads on 8 kv heads of hd 128
# (GQA group 4), causal.
LLAVA_TRAIN_SHAPE = (1, 32, 8, 5760, 128)
# The flash backward's kernels, by the name in their mangled symbols.  The
# tensor-core passes (bf16, every head dim) live in namespace tc ("2tc" in
# the symbol); the SIMT passes run f32 at every head dim.
BWD_KERNELS = ("flash_bwd_stats_kernel", "flash_bwd_prep_kernel",
               "flash_bwd_dkdv_kernel", "flash_bwd_group_sum_kernel",
               "flash_bwd_dq_kernel")
# Instantiations: the lse pass 2 dtypes x 4 head dims, the prep pass and
# the group sum 2 dtypes each, the SIMT dK / dV and dQ passes 4 each (f32 x
# 4), the tensor-core dK / dV and dQ passes 4 each (64, 80, 128, 256).
BWD_INSTANCES = 8 + 2 + 2 + 4 + 4 + 4 + 4
BWD_TC_INSTANCES = 8


def backward_build_evidence() -> None:
    """``nvcc -Xptxas -v``'s registers and spills for every instantiation
    of the flash backward's kernels (none may spill), and the count of
    ``HGMMA`` instructions in each one's SASS: every tensor-core (tc)
    instantiation must hold them, hd 256's dK / dV and dQ passes included,
    the SIMT ones none."""
    import re

    from repro_torch.kernels import build

    def label(name):
        kind = next((k for k in BWD_KERNELS if k in name), None)
        if kind is None:
            return None
        tc = "2tc" in name
        dt = "bf16" if tc or "nv_bfloat16" in name else "f32"
        hd = re.findall(r"Li(\d+)E", name.split(kind, 1)[1])
        return f"{'tc::' if tc else ''}{kind}<{', '.join([dt, *hd])}>"

    kernels, fn = {}, None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '([^' ]+)", line)
        if m:
            fn = label(m.group(1))
            if fn:
                kernels[fn] = [None, None]
        elif fn and "spill stores" in line:
            kernels[fn][1] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", line))
        elif fn and "Used" in line and "registers" in line:
            kernels[fn][0] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
    check(len(kernels) == BWD_INSTANCES,
          f"ptxas lines for {len(kernels)} flash backward kernels, expected "
          f"{BWD_INSTANCES}")
    print("  ptxas: " + "; ".join(f"{fn} {regs} regs, {spill} B spilled"
                                  for fn, (regs, spill) in kernels.items()))
    check(all(spill == 0 for _, spill in kernels.values()),
          "a flash backward kernel spills")
    counts = hgmma_counts("flash_bwd_")
    if counts is None:
        print("  cuobjdump not found: no SASS count")
        return
    hgmma = {label(name): n for name, n in counts.items()}
    print("  SASS HGMMA: " + "; ".join(f"{fn} {n}"
                                       for fn, n in hgmma.items()))
    tc = [fn for fn in hgmma if fn.startswith("tc::")]
    check(len(tc) == BWD_TC_INSTANCES,
          f"{len(tc)} tensor-core backward kernels in the SASS")
    check(all(hgmma[fn] > 0 for fn in tc),
          "a tensor-core backward kernel holds no HGMMA")
    for kind in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
        check(hgmma.get(f"tc::{kind}<bf16, 256>", 0) > 0,
              f"no HGMMA in tc::{kind} at hd 256")
    check(all(n == 0 for fn, n in hgmma.items() if fn not in tc),
          "a SIMT backward kernel holds HGMMA")


def flash_backward_phase(dev, shape=TRAIN_SHAPE, gemma=GEMMA_SHAPE,
                         hubert=HUBERT_TRAIN_SHAPE, llava=LLAVA_TRAIN_SHAPE,
                         gemma_train=GEMMA_TRAIN_SHAPE, iters: int = 5) -> tuple:
    """The flash kernels of training against their plain versions on the
    card: at the training shape, at gemma3-12b's shapes (hd 256, window
    1024 and 0, at S = 2048 and at its training round's 4096; the
    tensor-core passes in bf16, also at GQA groups 1, 2 and 16 and ragged
    lengths), at hubert-xlarge's training shape (hd 80, non-causal, f32
    and bf16) and a causal hd 80 shape at GQA group 4, at
    llava-next-mistral-7b's training shape (bf16, group 4, no share
    split), at GQA groups 1, 4 and 16, in f32 and bf16, at edge lengths.
    First the forward kernel's o against the plain forward's (phase 3's
    tolerance, ``bf16_tolerance`` or 2e-5; at the training shape with
    phase 3's mask fault, which must miss), and its logsumexp against
    ``torch.logsumexp`` of the plain masked scores
    (``flash_attention.lse_tolerance``, their f32 order bound).  Then the
    backward kernels, given the forward kernel's o and lse as in training,
    against the plain backward, given the plain forward's o: neither side
    reads the other's values.  Tolerance:
    ``flash_attention.backward_tolerance`` (both compute in f32 in their own
    orders; one bf16 ulp of the outputs; for bf16 inputs 2^-8 of the
    magnitudes for the tensor-core passes' roundings of P^T and dS), with
    ``o_err`` the forward's tolerance (what the two o's may differ by moves
    D = rowsum(dO o), and with it dq and dk).  The backward's mask fault
    runs the kernel on q, o, dO and lse moved down one row (each row's mask
    one key late): its dq must miss the tolerance, at the training shape
    and at gemma3-12b's; at hubert's shape (bf16) the fault is a causal
    mask on the non-causal inputs.  At those shapes two calls on the same
    inputs must give the same bits.  Each case
    prints the kernels one call launched and the dK / dV shares it summed
    (:func:`backward_shares`).  Then its time at the training
    shape, at gemma3-12b's local and global layers (S = 2048 and its
    training round's 4096), and at hubert's training shape beside its bound (10
    hd FLOP per open pair at the tensor-core peak of its dtype, bytes of q,
    k, v, o, dO in and dq, dk, dv out), the plain version's and SDPA's
    backward (``enable_gqa``, the same mask, on the same inputs).  Returns
    the JSON rows of the training shape, of hd 80 (hubert's) and of hd 256
    (gemma3-12b's global layer at S = 2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        (shape, bf16, True, 0),  # the training shape
        (gemma, bf16, True, LOCAL_WINDOW),  # gemma3-12b, a local layer
        (gemma, bf16, True, 0),  # and a global one
        (gemma_train, bf16, True, LOCAL_WINDOW),  # its training round's
        (gemma_train, bf16, True, 0),
        ((1, 16, 1, 33, 256), bf16, True, 0),  # hd 256: group 16, ragged
        ((2, 8, 4, 2049, 256), bf16, True, 0),  # group 2, ragged
        ((2, 8, 8, 300, 256), bf16, False, 100),  # group 1
        ((2, 8, 8, 1000, 128), bf16, True, 0),  # group 1, ragged
        ((2, 16, 4, 777, 64), f32, False, 100),  # group 4, non-causal
        ((2, 16, 4, 777, 64), bf16, True, 100),
        ((1, 32, 2, 300, 128), bf16, True, 0),  # group 16, ragged
        ((1, 32, 2, 300, 128), f32, True, 0),
        ((1, 4, 1, 300, 256), f32, True, 33),
        ((2, 8, 2, 1, 64), bf16, True, 0),  # S = 1
        ((2, 8, 2, 65, 64), f32, False, 0),  # a tile and one row
        ((1, 8, 2, 129, 256), bf16, False, 40),
        (hubert, bf16, False, 0),  # hubert-xlarge's training shape, hd 80
        (hubert, f32, False, 0),
        ((1, 8, 2, 300, 80), bf16, True, 100),  # hd 80, group 4, ragged
        ((1, 8, 2, 300, 80), f32, True, 0),
        (llava, bf16, True, 0),  # llava-next-mistral-7b's training shape
    ]

    def inputs(shp, dt):
        b, h, kv, s, hd = shp
        return [torch.randn(b, n, s, hd, generator=gen, device=dev).to(dt)
                for n in (h, kv, kv, h)]

    faults = (shape, gemma, gemma_train)  # mask fault and determinism
    errs = {}
    for shp, dt, causal, win in cases:
        q, k, v, do = inputs(shp, dt)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal, win)
        o_plain, lse_plain = fa.flash_attention_plain(q, k, v, causal, win,
                                                      return_lse=True)
        o_tol = (fa.bf16_tolerance(v, o_plain, causal, win) if dt == bf16
                 else torch.full_like(o_plain, 2e-5, dtype=f32))
        sync(dev)
        ratio = float(((o.float() - o_plain.float()).abs() / o_tol).max())
        lse_ratio = float(((lse - lse_plain).abs() / fa.lse_tolerance(
            q, k, lse_plain, causal, win)).max())
        print(f"  flash forward (B,H,KV,S,hd)={shp} {str(dt)[6:]} "
              f"causal={causal} window={win}: max|err| "
              f"{max_err(o, o_plain):.3e}, {ratio:.3f} of its tolerance; "
              f"lse max|err| {max_err(lse, lse_plain):.3e}, {lse_ratio:.2e} "
              f"of its tolerance")
        check(ratio <= 1.0,
              f"flash forward disagrees ({shp}, {dt}, {causal}, {win})")
        check(lse_ratio <= 1.0,
              f"flash forward's lse disagrees ({shp}, {dt}, {causal}, {win})")
        del lse_plain
        if shp == shape:  # phase 3's mask fault must miss
            fault = fa.flash_attention(torch.roll(q, 1, 2), k, v, causal, win)
            sync(dev)
            miss = float(((fault[:, :, 1:].float()
                           - o_plain[:, :, :-1].float()).abs()
                          / o_tol[:, :, :-1]).max())
            print(f"    forward, mask one key late (q moved down one row): "
                  f"{miss:.3f} of the tolerance (must exceed 1)")
            check(miss > 1.0, "the forward tolerance misses a mask fault at "
                              "the training shape")
            del fault
        before = fa.backward_kernel_launches
        got = fa.flash_attention_backward(q, k, v, o, do, causal, win, lse)
        per_call = fa.backward_kernel_launches - before
        want = fa.flash_attention_backward_plain(q, k, v, o_plain, do,
                                                 causal, win)
        tol = fa.backward_tolerance(q, k, v, o_plain, do, want, causal, win,
                                    o_err=o_tol)
        del o_plain, o_tol
        sync(dev)
        ratios = [float(((a.float() - b.float()).abs() / t).max())
                  for a, b, t in zip(got, want, tol)]
        e = max(max_err(a, b) for a, b in zip(got, want))
        print(f"  flash backward (B,H,KV,S,hd)={shp} {str(dt)[6:]} "
              f"causal={causal} window={win}: max|err| {e:.3e}; dq, dk, dv at "
              + ", ".join(f"{r:.4f}" for r in ratios) + " of the tolerance; "
              f"{per_call} kernel launches a call ("
              + ("tensor cores" if fa.on_tensor_cores(dt, shp[4])
                 else "SIMT") + "), dK / dV shares "
              + backward_shares(q, shp[2]))
        check(max(ratios) <= 1.0,
              f"flash backward disagrees ({shp}, {dt}, {causal}, {win})")
        errs[shp, dt, causal, win] = e
        if shp in faults:  # the mask fault must miss
            roll = [torch.roll(t, 1, 2) for t in (q, o, do, lse)]
            fault = fa.flash_attention_backward(roll[0], k, v, roll[1],
                                                roll[2], causal, win,
                                                roll[3])[0]
            sync(dev)
            miss = float(((fault[:, :, 1:].float() - want[0][:, :, :-1].float())
                          .abs() / tol[0][:, :, :-1]).max())
            print(f"    mask one key late (q, o, dO, lse moved down one "
                  f"row): dq at {miss:.1f} of the widened tolerance (must "
                  f"exceed 1)")
            check(miss > 1.0, "the backward tolerance misses a mask fault")
            del fault, roll
            again = fa.flash_attention_backward(q, k, v, o, do, causal, win,
                                                lse)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"    two calls on the same inputs bitwise equal: {same}")
            check(same, "the flash backward is not deterministic")
            del again
        if shp == hubert and dt == bf16:  # a causal mask must miss
            fault = fa.flash_attention_backward(q, k, v, o, do, True, 0,
                                                lse)[0]
            sync(dev)
            miss = float(((fault.float() - want[0].float()).abs()
                          / tol[0]).max())
            print(f"    hd 80 under a causal mask: dq at {miss:.1f} of the "
                  f"widened tolerance (must exceed 1)")
            check(miss > 1.0, "the hd 80 backward tolerance misses a causal "
                              "mask")
            del fault
        del q, k, v, do, o, lse, got, want, tol
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def timed(shp, win, what, causal=True):
        b, h, kv, s, hd = shp
        q, k, v, do = inputs(shp, bf16)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal, win)
        cost = flash_backward_cost(b, h, kv, s, hd, causal, win,
                                   q.element_size(), lse=True)
        flops = cost.flops
        bound, by = cost.bound_ms(BF16_FLOP_PER_S)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        if not causal:
            out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True)
        elif win:
            ar = torch.arange(s, device=dev)
            mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :]
                                                   < win)
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                 enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            out, (qg, kg, vg), do, retain_graph=True)
        r = dict(
            max_abs_err=errs[shp, bf16, causal, win],
            ms=timed_ms(lambda: fa.flash_attention_backward(
                q, k, v, o, do, causal, win, lse), dev, iters),
            plain_ms=timed_ms(lambda: fa.flash_attention_backward_plain(
                q, k, v, o, do, causal, win), dev, max(iters // 5, 1)),
            bound_ms=bound, bound_by=by,
            library_ms=timed_ms(lib, dev, iters),
        )
        print(f"  flash backward {what} (B,H,KV,S,hd)={shp} causal={causal} "
              f"window {win}: "
              f"{r['ms']:.4f} ms for {flops:.4g} FLOP "
              f"({flops / r['ms'] / 1e9:.2f} TFLOP/s), bound {bound:.4f} ms "
              f"at the bf16 tensor-core peak ({by}), "
              f"{100 * bound / r['ms']:.1f}% of it; plain {r['plain_ms']:.4f} "
              f"ms; SDPA backward {r['library_ms']:.4f} ms; kernel/SDPA "
              f"{r['ms'] / r['library_ms']:.3f}")
        del out, lib
        return r

    row = timed(shape, 0, "glm4-9b training")  # the JSON rows
    timed(gemma, LOCAL_WINDOW, "gemma3-12b local layer")
    hd256 = timed(gemma, 0, "gemma3-12b global layer")
    timed(gemma_train, LOCAL_WINDOW, "gemma3-12b training, local layer")
    timed(gemma_train, 0, "gemma3-12b training, global layer")
    timed(llava, 0, "llava-next-mistral-7b training")
    return (row, timed(hubert, 0, "hubert-xlarge training", causal=False),
            hd256)


def round_batches(cfg, rounds: int, batch: int, seq: int,
                  local_steps: int = 2, device="cpu") -> dict:
    """The batches of ``rounds`` pod rounds of ``cfg``'s task, 2 pods,
    arrays of shape (rounds, 2, K, batch, ...): ``make_lm_stream`` tokens
    for the lm task, as ``launch.train.run`` draws them, else one
    ``configs.registry.make_round_batches`` draw (seed 1), as the
    reference's dry-run feeds its round."""
    from repro_torch.configs.registry import make_round_batches
    from repro_torch.data.synthetic import make_lm_stream

    if cfg.task != "lm":
        return make_round_batches(cfg, rounds, 2, local_steps, batch, seq,
                                  seed=1, device=device)
    toks = make_lm_stream(cfg.vocab_size, seq,
                          rounds * 2 * local_steps * batch)
    return {"tokens": toks.reshape(rounds, 2, local_steps, batch, seq)
            .to(device)}


def train_parity(dev, seq: int = 128, batch: int = 2, rounds: int = 2,
                 arch: str = "glm4-9b", cfg=None, calibrate: bool = False):
    """Reduced ``arch`` (glm4-9b: f32, 2 layers, hd 64), or ``cfg`` where
    given, 2 pods, K = 2: ``rounds`` rounds of ``make_round_step`` on the
    card against the same on the CPU, from the same params (two distinct
    replicas) and batches (:func:`round_batches`), once with the dense
    ``P_pod`` (the dense mix) and
    once with ``pod_mixing_neighbors`` (the gather).  Tolerance: f32 on
    both, sums in other orders (cuBLAS and the kernels against the CPU's),
    carried through 2 rounds without a restart: params and momentum within
    1e-4 of each leaf's largest magnitude (the CPU against the reference
    measured 1e-6 a round), w within 1e-6, the loss within 1e-5 relative,
    the accuracy within one flipped token a step (one position of
    ``configs.registry.step_positions``).  With ``calibrate`` (a
    model whose training is ill-conditioned at random init: xLSTM's mLSTM
    floor, ``tests/_torch_blocks.py``), a leaf may also lie within twice
    what the CPU's own leaf moves when the params take 1e-6 relative noise
    (the most over 2 draws, with the dense mix), and the accuracy within 2%
    of a step's tokens."""
    from repro_torch.configs.registry import get_config, step_positions
    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    cpu = torch.device("cpu")
    api = get_model_api(cfg or get_config(arch, smoke=True))
    base = api.init(torch.Generator().manual_seed(0), cpu)
    stacked = tree_map(lambda x: torch.stack([x, 0.5 * x]), base)
    data = round_batches(api.cfg, rounds, batch, seq)
    step_cfg = steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05, local_steps=2)

    def run(d, make_P, noise=None):
        round_step = steps.make_round_step(api, step_cfg)
        params = tree_map(lambda x: x.to(d).clone(), stacked)
        if noise is not None:
            gen = torch.Generator().manual_seed(noise)
            tree_map(lambda x: x.mul_(1 + 1e-6 * torch.randn(
                x.shape, generator=gen)), params)
        v = tree_map(torch.zeros_like, params)
        w = torch.ones(2, device=d)
        P = make_P(2, d)
        zero_counts()
        hist = []
        for r in range(rounds):
            params, v, w, _, _, m = round_step(
                params, v, w, (), (), {k: x[r].to(d) for k, x in data.items()},
                P)
            hist.append((float(m["loss"]), float(m["acc"])))
        return (tree_flatten(params)[1], tree_flatten(v)[1], w.cpu(), hist,
                read_counts())

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / float(b.abs().max())

    step_tokens = step_positions(data)
    acc_tol = (max(1, int(0.02 * step_tokens)) if calibrate else 1) / step_tokens
    attn_layers = 0 if api.cfg.block_kind == "xlstm" else api.cfg.n_layers
    hd80 = api.cfg.resolved_head_dim == 80
    for name, make_P, mix in (
            ("dense", steps.pod_mixing_matrix, "gossip_matmul"),
            ("neighbors", steps.pod_mixing_neighbors, "gossip_gather")):
        gp, gv, gw, gh, used = run(dev, make_P)
        cp, cv, cw, ch, _ = run(cpu, make_P)
        if name == "dense":  # the drift is the model's; both mixes use it
            noisy = ([run(cpu, make_P, seed) for seed in (1, 2)]
                     if calibrate else [])
        worst = {}
        for what, got, want, k in (("params", gp, cp, 0), ("v", gv, cv, 1)):
            # each leaf's error over its tolerance
            worst[what] = max(
                rel(x, y) / max([1e-4] + [2 * rel(n[k][i], y) for n in noisy])
                for i, (x, y) in enumerate(zip(got, want)))
        dw = float((gw - cw).abs().max())
        dl = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(gh, ch))
        da = max(abs(a[1] - b[1]) for a, b in zip(gh, ch))
        print(f"  {api.cfg.name} {name} P_pod, {rounds} rounds card against "
              f"CPU: params {worst['params']:.3f} and v {worst['v']:.3f} of "
              "their tolerance (1e-4 of each leaf's largest magnitude"
              + (", or twice the CPU's drift under 1e-6 noise" if calibrate
                 else "") + f"), w {dw:.3e} (1e-6), loss {dl:.3e} relative "
              f"(1e-5), acc {da:.4f} ({acc_tol:.4f}); card losses "
              f"{[round(h[0], 5) for h in gh]}; launches {used}")
        check(worst["params"] <= 1.0 and worst["v"] <= 1.0 and dw <= 1e-6
              and dl <= 1e-5 and da <= acc_tol,
              f"training round on the card disagrees with the CPU ({name})")
        want_bwd = rounds * 2 * 2 * 2 * attn_layers
        check(used[mix] == rounds and used["flash_attention_backward"]
              == want_bwd and used["flash_attention_backward_hd80"]
              == (want_bwd if hd80 else 0), f"{name}: launches {used}")


def print_train_split(prof, wall_s: float) -> None:
    """``print_profile``, then the device time of a training round by kind:
    flash forward, flash backward, matmuls, the mix, the rest."""
    split = {"flash forward": 0.0, "flash backward": 0.0, "matmuls": 0.0,
             "mix": 0.0, "rest": 0.0}
    for e in print_profile(prof, wall_s, top=10, also=("flash", "mix_")):
        name = e.key.lower()
        if "flash_attention_kernel" in name:
            kind = "flash forward"
        elif "flash_bwd_" in name:
            kind = "flash backward"
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma",
                                     "sm90_", "cublas")):
            kind = "matmuls"
        elif any(t in name for t in ("mix_resident", "mix_tiled", "gather_")):
            kind = "mix"
        else:
            kind = "rest"
        split[kind] += e.self_device_time_total / 1e3
    total = sum(split.values())
    print("  training round device time by kind: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / max(total, 1e-9):.1f}%)"
        for k, v in split.items()))


def mix_check(dev, params, P) -> None:
    """The dense mix at the pod bank's width (two f32 rows of the replicas'
    2.06 B parameters, each more than 2^31 bytes) against its plain version
    on column slices at the start, the middle and the end (the last column
    included); tolerance as phase 3's, 1e-6 of max|Y| in f32.  Then its
    time beside its bound and ``torch.matmul``'s on the same bank."""
    from repro_torch.core.flat import make_spec, tree_map
    from repro_torch.kernels import gossip_matmul as gm

    spec = make_spec(tree_map(lambda x: x[0], params))
    X = spec.ravel_stacked(params)
    Y = gm.gossip_matmul(P, X)
    d = X.shape[1]
    width = min(1 << 22, d)
    print(f"  the mix at the pod bank's width: ({X.shape[0]}, {d}) "
          f"{str(X.dtype)[6:]}, {d * X.element_size() / 2 ** 30:.2f} GiB a "
          f"row ({d * X.element_size()} bytes)")
    for a in (0, (d - width) // 2, d - width):
        want = gm.gossip_matmul_plain(P, X[:, a:a + width])
        e = max_err(Y[:, a:a + width], want)
        tol = 1e-6 * float(want.abs().max())
        print(f"    columns {a}..{a + width - 1}: max|err| {e:.3e} "
              f"(tolerance {tol:.3e})")
        check(e <= tol, f"the mix disagrees at columns {a}..{a + width - 1}")
    del Y
    n = X.shape[0]
    t_kernel = timed_ms(lambda: gm.gossip_matmul(P, X), dev, 3, 1)
    b, by = dense_mix_cost(n, n, d, 4).bound_ms()
    try:
        lib = f"{timed_ms(lambda: torch.matmul(P.float(), X), dev, 3, 1):.4f} ms"
    except RuntimeError as e:  # a library call may refuse 2^31 columns
        lib = f"refused ({str(e).splitlines()[0][:120]})"
    print(f"    the mix at the pod bank's width: {t_kernel:.4f} ms, bound "
          f"{b:.4f} ms ({by}), {100 * b / t_kernel:.1f}% of it; torch.matmul "
          f"(f32, TF32 off) {lib}")
    del X


def training(dev, layers: int = TRAIN_LAYERS, argv=TRAIN_ARGV,
             cfg=None) -> dict:
    """The training main path through the port's launcher function,
    ``repro_torch.launch.train.run``: glm4-9b at full width (d_model 4096,
    32 on 2 heads, hd 128, d_ff 13,696, vocab 151,552, bf16) with its 40
    layers cut to ``layers``, 2 pods, K = 2, 1 x 4096 tokens a pod a step
    from ``make_lm_stream``, lr 0.05, alpha 0.9, rho 0.05, 3 rounds: each
    round's loss, accuracy, w_mass, wall time and launches; peak memory;
    then, on the state that run left, a profiled round split by kind and
    the mix at the bank's width against its plain version.  ``cfg`` replaces
    the architecture's config (a CPU rehearsal passes a reduced one)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(cfg or get_config("glm4-9b"), n_layers=layers)
    args = train.build_parser().parse_args(argv + ["--device", dev.type])
    per_step = 2 * args.local_steps * train.N_PODS * cfg.n_layers  # 2 passes
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the training path's counts start here
    per_round, last = [], [read_counts()]

    def on_round(r, rec):
        now = read_counts()
        per_round.append({k: now[k] - last[0][k] for k in now})
        last[0] = now
        print(f"  round {r}: loss {rec['loss']:.4f} acc {rec['acc']:.4f} "
              f"w_mass {rec['w_mass']:.6f} wall {rec['dt']:.3f} s launches "
              f"{per_round[-1]}", flush=True)

    t = time.perf_counter()
    rec = train.run(cfg, args, on_round=on_round)
    wall = time.perf_counter() - t
    launches = read_counts()
    api = rec["api"]
    print(f"  {cfg.name} cut to {cfg.n_layers} layers: "
          f"{api.num_params() / 1e9:.3f} B parameters a replica, remat "
          f"{cfg.remat}; train.run {wall:.1f} s (parameter init included)")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    fwd_per_round = per_step * (2 if cfg.remat else 1)  # remat recomputes
    per_call = (per_round[0]["flash_attention_backward_kernels"]
                / max(per_round[0]["flash_attention_backward"], 1))
    print(f"  flash backward: {per_call:g} kernel launches a call (D, dK / dV, "
          f"the group sum, dQ), {per_round[0]['flash_attention_backward']} "
          "calls a round")
    for h, used in zip(rec["history"], per_round):
        check(math.isfinite(h["loss"]), f"round {h['round']}: loss {h['loss']}")
        check(used["flash_attention_backward_kernels"]
              == BWD_TRAIN_PASSES * used["flash_attention_backward"],
              f"round {h['round']}: {used['flash_attention_backward_kernels']}"
              f" backward kernels for {used['flash_attention_backward']} calls")
        check(abs(h["w_mass"] - train.N_PODS) <= 1e-3,
              f"round {h['round']}: w_mass {h['w_mass']}")
        check(used["flash_attention_backward"] == per_step
              and used["flash_attention"] == fwd_per_round
              and used["gossip_matmul"] == 1 and used["gossip_gather"] == 0
              and used["fused_update_bank"] == 0,
              f"round {h['round']}: launches {used}, expected "
              f"{per_step} backward, {fwd_per_round} forward, 1 dense mix")
    check(len(rec["history"]) == 3, f"{len(rec['history'])} rounds")

    state = [rec[k] for k in ("params", "v", "w", "comp", "link")]
    with torch.profiler.profile() as prof:
        t = time.perf_counter()
        rec["round_step"](*state, {"tokens": rec["tokens"][0].to(dev)},
                          rec["P_pod"])
        sync(dev)
        wall = time.perf_counter() - t
    print(f"  profiled round {wall:.3f} s:")
    print_train_split(prof, wall)
    del prof
    mix_check(dev, rec["params"], rec["P_pod"])
    return launches


# -- phase 13: serving the MoE family -----------------------------------------

# Each MoE model at full width, its depth cut so that its bf16 weights and
# the prefill's activations fit one 80 GB card: (layers kept, requests).
MOE_SERVE = {"dbrx-132b": (8, 4), "deepseek-v3-671b": (2, 1)}
MOE_PROMPT, MOE_NEW = 2048, 16
# The profile's ranges: the port's functions each wraps, by kind.
MOE_SPANS = {"expert products": ("moe", ("_expert_products",)),
             "dispatch/combine": ("moe", ("moe_positions", "_dispatch",
                                          "_combine")),
             "MLA": ("attention", ("mla_forward", "mla_decode"))}


@contextlib.contextmanager
def patched(module, **fns):
    """Replace attributes of ``module`` while the block runs."""
    saved = {k: getattr(module, k) for k in fns}
    for k, fn in fns.items():
        setattr(module, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


@contextlib.contextmanager
def recorded_routing(sels: list):
    """Append each call's top-k choice (B, S, k) of the port's router
    (``models.moe._router_probs``) to ``sels`` while the block runs; the
    call's results are returned unchanged."""
    from repro_torch.models import moe

    router = moe._router_probs

    def spy(p, x, cfg):
        out = router(p, x, cfg)
        sels.append(out[1].clone())
        return out

    with patched(moe, _router_probs=spy):
        yield


@contextlib.contextmanager
def spans():
    """Run each function of ``MOE_SPANS`` under a ``record_function`` range
    named by its kind, so that a profile can sum the device time of the
    kernels each kind launched."""
    import importlib

    stack = contextlib.ExitStack()
    with stack:
        for kind, (mod_name, names) in MOE_SPANS.items():
            mod = importlib.import_module(f"repro_torch.models.{mod_name}")

            def wrap(fn, kind=kind):
                def call(*args, **kw):
                    with torch.profiler.record_function(kind):
                        return fn(*args, **kw)
                return call

            stack.enter_context(patched(
                mod, **{n: wrap(getattr(mod, n)) for n in names}))
        yield


def routing_stats(sels, cfg) -> list:
    """Per layer of a prefill's recorded choices (B, S, k): the largest
    load of an expert in a batch row, and the assignments dropped."""
    from repro_torch.models import moe

    out = []
    for sel in sels:
        load = torch.zeros(sel.shape[0], cfg.n_experts, dtype=torch.int64,
                           device=sel.device)
        load.scatter_add_(1, sel.flatten(1), torch.ones_like(sel.flatten(1)))
        keep = moe.moe_positions(sel, cfg)[1]
        out.append((int(load.max()), int((~keep).sum())))
    return out


def moe_serving(dev, arch: str, layers: int, batch_n: int,
                s: int = MOE_PROMPT, new: int = MOE_NEW, cfg=None) -> dict:
    """The serving path of ``arch`` at full width (bf16, parameters drawn on
    the card from seed 0) with its depth cut to ``layers``: ``batch_n``
    requests of ``s`` prompt tokens through ``serve.generate``, ``new`` new
    tokens (cache of s + new).  Prints the times, peak memory, launches and
    each layer's largest expert load and drops; then a steady second run,
    a profiled prefill and decode step split by kind, and
    :func:`moe_decode_check`.  ``cfg`` replaces the architecture's config
    (a CPU rehearsal passes a reduced one)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model_api

    full = cfg or get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    api = get_model_api(cfg)
    print(f"  {arch}: {layers} of {full.n_layers} layers (the only cut: "
          f"widths as published), {api.num_params() / 1e9:.2f} B parameters "
          f"in {str(cfg.dtype)[6:]}; {cfg.n_experts} experts top "
          f"{cfg.top_k}, {cfg.attn_type}; {batch_n} x {s} prompt tokens, "
          f"{new} new; capacity {moe.moe_capacity(s, cfg)} an expert and row "
          f"at the prefill, {moe.moe_capacity(1, cfg)} at decode")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    sync(dev)
    print(f"  parameters drawn on the card in {time.perf_counter() - t:.1f} s")
    batch = make_batch(cfg, batch_n, s, seed=1, device=dev)
    sels = []
    zero_counts()  # this serving path's counts start here
    with recorded_routing(sels):
        rec = serve.generate(api, params, batch, new)
    launches = read_counts()
    steps = rec["steps"]
    print(f"  prefill {rec['prefill_s']:.4f} s (first call); decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{batch_n * steps / rec['decode_s']:.1f} tokens/s; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    stats = routing_stats(sels[:layers], cfg)
    print("  prefill routing by layer (largest expert load in a row, "
          "assignments dropped of " f"{sels[0].numel()}): "
          + "; ".join(f"{i}: {m}, {d}" for i, (m, d) in enumerate(stats)))
    check(rec["finite"], f"{arch}: a prefill or decode logit is not finite")
    check(tuple(rec["tokens"].shape) == (batch_n, new),
          f"{arch}: tokens {tuple(rec['tokens'].shape)}")
    check(len(sels) == layers * new, f"{arch}: {len(sels)} router calls")
    flash = layers if cfg.attn_type == "gqa" else 0
    check(launches["flash_attention"] == flash,
          f"{arch}: flash launches per prefill {launches['flash_attention']},"
          f" expected {flash}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"{arch}: the FL kernels ran on the serving path: {launches}")

    warm = serve.generate(api, params, batch, new)
    print(f"  steady serve.generate: prefill {warm['prefill_s']:.4f} s; decode "
          f"{1e3 * warm['decode_s'] / steps:.2f} ms/step, "
          f"{batch_n * steps / warm['decode_s']:.1f} tokens/s")
    del warm
    with torch.no_grad(), spans():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            logits, cache = api.prefill(params, batch, s + new)
            sync(dev)
            wall = time.perf_counter() - t
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        del logits
        print(f"  profiled prefill {wall:.4f} s:")
        print_split(prof, wall, "prefill", MOE_SPANS)
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            make_serve_step(api)(params, cache, tok, s)
            sync(dev)
            wall = time.perf_counter() - t
        del cache
    print(f"  profiled decode step {1e3 * wall:.2f} ms:")
    print_split(prof, wall, "decode step", MOE_SPANS)
    del prof
    moe_decode_check(api, params, batch, rec, sels)
    return launches


def moe_decode_check(api, params, batch, rec, sels, mutant="layer") -> float:
    """:func:`decode_check` of a MoE model, with the forward's routing
    pinned to the served path's.  Two things a dense model never had would
    otherwise decide the result: bf16 activations rounded at M = B*S
    against M = B move the f32 router logits by ulps and flip top-k choices
    at near-ties; and the capacity at S+N-1 tokens is not the capacity at S
    (644 against 640 for dbrx), while a decode step never drops.  So each
    layer of the forward takes the experts the served path chose for each
    position (the weights still from the forward's own probabilities) and
    keeps the assignments the served path kept: the prefill's under its
    capacity, every decode step's.  This wraps the port's router, capacity
    and position functions from here; the package has no switch for it.
    Prints the flips the pin absorbed, the drops, and the first position
    at which the forward's own capacity would keep another set.  The
    mutant (:func:`decode_check`'s; ``"layer"`` gives each decode step the
    layer before's cache, None for a one-layer model) must miss.  Returns
    the tolerance."""
    import functools

    from repro_torch.models import moe

    cfg = api.cfg
    n_layers, s, n = cfg.n_layers, batch["tokens"].shape[1], rec["logits"].shape[1]
    # Each layer's served choice and kept set, position by position: the
    # prefill's calls come first, then one call a layer each decode step.
    pinned, kept, caps = [], [], []
    own_first = s + n - 1  # where the forward's own capacity keeps another set
    for i in range(n_layers):
        steps = [sels[n_layers * (j + 1) + i] for j in range(n - 1)]
        pinned.append(torch.cat([sels[i]] + steps, 1))
        pre = moe.moe_positions(sels[i], cfg)[1]
        kept.append(torch.cat([pre, torch.ones_like(pre[:, :1]).expand(
            -1, n - 1, -1)], 1))
        pos, own = moe.moe_positions(pinned[i], cfg)
        differ = torch.nonzero((own != kept[i]).any(-1).any(0))
        if len(differ):
            own_first = min(own_first, int(differ[0, 0]))
        caps.append(int(pos[kept[i]].max()) + 1)
    state = {"layer": -1, "flips": 0}
    router, positions = moe._router_probs, moe.moe_positions

    def pinned_router(p, x, cfg_):
        state["layer"] += 1
        _, own, probs = router(p, x, cfg_)
        sel = pinned[state["layer"]]
        state["flips"] += int((own.sort(-1).values != sel.sort(-1).values)
                              .any(-1).sum())
        w = probs.gather(-1, sel)
        return w / (w.sum(-1, keepdim=True) + 1e-9), sel, probs

    def served_capacity(s_, cfg_):
        return caps[state["layer"]]

    def served_positions(sel, cfg_):
        return positions(sel, cfg_)[0], kept[state["layer"]]

    tol = decode_check(api, params, batch, rec, mutant=mutant,
                       pin=functools.partial(
                           patched, moe, _router_probs=pinned_router,
                           moe_capacity=served_capacity,
                           moe_positions=served_positions))
    check(state["layer"] == n_layers - 1,
          f"{state['layer'] + 1} router calls in the pinned forward")
    print(f"  the forward's routing pinned to the served path's: the pin "
          f"absorbed {state['flips']} flipped choices (tokens of any layer); "
          f"served drops by layer {[int((~k).sum()) for k in kept]}; the "
          f"forward's own capacity ({moe.moe_capacity(s + n - 1, cfg)}) "
          f"would first keep another set at position {own_first} "
          f"({max(0, min(n, own_first - s + 1))} of the {n} positions "
          "before it)")
    return tol


# -- phase 14: the vlm and masked_lm tasks -------------------------------------

# hubert-xlarge's encoder at phase 14: 8 clips of 1500 frames (30 s each at
# HuBERT's 20 ms frame rate), 16 query heads on 16 kv heads of hd 80 (1280 /
# 16), bf16, non-causal.
HUBERT_CLIPS, HUBERT_FRAMES = 8, 1500
HUBERT_SHAPE = (HUBERT_CLIPS, 16, 16, HUBERT_FRAMES, 80)
# llava-next-mistral-7b's prefill at phase 14: 4 requests of 2880 image
# embeddings (the config's anyres count) and 2880 text tokens, 32 query
# heads on 8 kv heads of hd 128, causal.
LLAVA_REQUESTS, LLAVA_SEQ, LLAVA_NEW = 4, 5760, 16
LLAVA_SHAPE = (LLAVA_REQUESTS, 32, 8, LLAVA_SEQ, 128)


def flash_hd80_phase(dev, hubert=HUBERT_SHAPE, llava=LLAVA_SHAPE,
                     lengths=(1, 63, 65, 1000), iters: int = 10) -> dict:
    """The flash kernel at hd 80 against its plain version: f32 (the SIMT
    kernel) and bf16 (the tensor-core kernel's 16-column panels), causal
    and non-causal, GQA groups 1 and 4, S = ``lengths``, and hubert-xlarge's
    shape (non-causal); each held to its tolerance (2e-5 in f32,
    ``bf16_tolerance`` in bf16, as in phase 3).  Two faults must miss it: q
    moved down one row on a causal bf16 shape (each row's mask one key
    late), and a causal mask on hubert's inputs.  Then the kernel's time at
    hubert's shape beside its bound (4 hd FLOP an open pair at the bf16
    peak), the plain version's and SDPA's on the same inputs; and the
    forward at llava-next-mistral-7b's prefill shape (hd 128, causal)
    beside its bound and SDPA, with its first GQA group (4 query heads on
    kv head 0) held to the plain version.  Returns the hd 80 row of the
    JSON record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((2, h, kv, s, 80), dt, causal)
             for dt in (bf16, f32) for causal in (True, False)
             for h, kv in ((8, 8), (8, 2)) for s in lengths]
    cases.append((hubert, bf16, False))
    fault_shape = (2, 8, 2, max(lengths), 80)

    def qkv(shp, dt):
        b_, h_, kv_, s_, hd_ = shp
        return [torch.randn(b_, n_, s_, hd_, generator=gen, device=dev).to(dt)
                for n_ in (h_, kv_, kv_)]

    def ratio(got, want, tol):
        return float(((got.float() - want.float()).abs() / tol).max())

    worst, errs = {}, {}
    for shp, dt, causal in cases:
        q, k, v = qkv(shp, dt)
        got = fa.flash_attention(q, k, v, causal, 0)
        want = fa.flash_attention_plain(q, k, v, causal, 0)
        sync(dev)
        tol = (fa.bf16_tolerance(v, want, causal, 0) if dt == bf16
               else torch.full_like(want, 2e-5, dtype=f32))
        r = ratio(got, want, tol)
        key = (str(dt)[6:], causal)
        worst[key] = max(worst.get(key, 0.0), r)
        errs[shp, dt, causal] = max_err(got, want)
        check(r <= 1.0, f"flash_attention at hd 80 disagrees ({shp}, {dt}, "
                        f"causal={causal}): {r:.3f} of its tolerance")
        if shp == fault_shape and dt == bf16 and causal:
            fault = fa.flash_attention(torch.roll(q, 1, 2), k, v, causal, 0)
            sync(dev)
            miss = ratio(fault[:, :, 1:], want[:, :, :-1], tol[:, :, :-1])
            print(f"  hd 80 mask one key late (q moved down one row) at "
                  f"{shp}: {miss:.3f} of the tolerance (must exceed 1)")
            check(miss > 1.0, "the hd 80 bf16 tolerance misses a mask fault")
        if shp == hubert:
            fault = fa.flash_attention(q, k, v, True, 0)
            sync(dev)
            miss = ratio(fault, want, tol)
            print(f"  hubert's shape {shp} under a causal mask: {miss:.3f} "
                  "of the tolerance (must exceed 1)")
            check(miss > 1.0, "the hd 80 tolerance misses a causal mask")
        del q, k, v, got, want, tol
    print(f"  flash_attention at hd 80, {len(cases)} shapes (B, H, KV, S) = "
          f"(2, 8, 8 or 2, {', '.join(map(str, lengths))}) and {hubert[:4]}: "
          "largest |err| / tolerance " + ", ".join(
              f"{dt} causal={c} {r:.3f}" for (dt, c), r in worst.items())
          + " (2e-5 in f32; 2e-5 + 2^-8 max_row|v| + 2^-7 |out| in bf16)")

    def bound_of(shp, causal):
        b_, h_, kv_, s_, hd_ = shp
        cost = flash_forward_cost(b_, h_, kv_, s_, hd_, causal, 0, 2)
        return cost.bound_ms(BF16_FLOP_PER_S) + (cost.flops,)

    q, k, v = qkv(hubert, bf16)
    bound, by, flops = bound_of(hubert, False)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, enable_gqa=True)
    row = dict(
        max_abs_err=errs[hubert, bf16, False],
        ms=timed_ms(lambda: fa.flash_attention(q, k, v, False, 0), dev, iters),
        plain_ms=timed_ms(lambda: fa.flash_attention_plain(q, k, v, False, 0),
                          dev, max(iters // 5, 1)),
        bound_ms=bound, bound_by=by, library_ms=timed_ms(lib, dev, iters))
    lib_err = max_err(lib(), fa.flash_attention_plain(q, k, v, False, 0))
    print(f"  flash_attention hubert-xlarge (B,H,KV,S,hd)={hubert} "
          f"non-causal: {row['ms']:.4f} ms for {flops:.4g} FLOP "
          f"({flops / row['ms'] / 1e9:.2f} TFLOP/s), bound {bound:.4f} ms at "
          f"the bf16 tensor-core peak ({by}), {100 * bound / row['ms']:.1f}% "
          f"of it; plain {row['plain_ms']:.4f} ms; SDPA "
          f"{row['library_ms']:.4f} ms (max|SDPA - plain| {lib_err:.3e}); "
          f"kernel/SDPA {row['ms'] / row['library_ms']:.3f}")
    del q, k, v

    q, k, v = qkv(llava, bf16)
    got = fa.flash_attention(q, k, v, True, 0)
    group = llava[1] // llava[2]
    want = fa.flash_attention_plain(q[:, :group], k[:, :1], v[:, :1], True, 0)
    r = ratio(got[:, :group], want,
              fa.bf16_tolerance(v[:, :1], want, True, 0))
    del got, want
    print(f"  llava-next-mistral-7b's prefill shape {llava}: kv head 0's "
          f"{group} query heads against the plain version: {r:.3f} of the "
          "bf16 tolerance")
    check(r <= 1.0, "flash_attention disagrees at llava's prefill shape")
    bound, by, flops = bound_of(llava, True)
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, True, 0), dev, iters)
    lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), dev, iters)
    print(f"  flash_attention llava-next-mistral-7b prefill (B,H,KV,S,hd)="
          f"{llava} causal: {ms:.4f} ms for {flops:.4g} FLOP "
          f"({flops / ms / 1e9:.2f} TFLOP/s), bound {bound:.4f} ms ({by}), "
          f"{100 * bound / ms:.1f}% of it; SDPA {lib_ms:.4f} ms; kernel/SDPA "
          f"{ms / lib_ms:.3f} (plain not timed: its f32 scores alone would "
          f"take {4 * llava[0] * llava[1] * llava[3] ** 2 / 1e9:.0f} GB)")
    return row


def encoder_parity(dev, s: int = 100) -> None:
    """Reduced hubert-xlarge at hd 80 (``reduced`` gives 4 heads of 64 at
    d_model 256; d_model 320 gives 4 heads of 80), f32,
    ``forward`` and ``loss`` of one ``make_batch`` batch (2 x ``s``
    frames) on ``dev`` against the same on the CPU: the card runs the
    SIMT flash kernel at hd 80, non-causal, once a layer a call.  Both
    sides sum in their own orders (cuBLAS, the kernel's online softmax):
    logits within 1e-4 of their magnitude, the loss within 1e-4 of
    itself."""
    import dataclasses

    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.core.flat import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import get_model_api

    cfg = dataclasses.replace(get_config("hubert-xlarge", smoke=True),
                              d_model=320)
    api = get_model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, 2, s, seed=1)
    runs = {}
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda t, d=d: t.to(d), params)
        b = {k: v.to(d) for k, v in batch.items()}
        before = fa.head_dim_launches[80]
        with torch.no_grad():
            logits = api.forward(p, b)[0].cpu()
            loss = float(api.loss(p, b)[0])
        runs[d.type] = (logits, loss, fa.head_dim_launches[80] - before)
    (want, want_loss, _), (got, got_loss, used) = runs["cpu"], runs[dev.type]
    e, tol = max_err(got, want), 1e-4 * float(want.abs().max())
    print(f"  reduced hubert-xlarge at hd {cfg.resolved_head_dim} "
          f"({cfg.n_heads} heads on {cfg.n_kv_heads}), 2 x {s} frames: "
          f"logits max|err| {e:.3e} (tolerance {tol:.3e}); loss {got_loss:.6f} "
          f"against {want_loss:.6f}; hd 80 flash launches on the card {used} "
          f"(one a layer a call: {2 * cfg.n_layers})")
    check(e <= tol, "hubert: card and CPU logits disagree")
    check(abs(got_loss - want_loss) <= 1e-4 * abs(want_loss),
          "hubert: card and CPU losses disagree")
    if dev.type == "cuda":
        check(used == 2 * cfg.n_layers, f"hubert: hd 80 flash launches {used}")


def vlm_serving(dev, batch_n: int = LLAVA_REQUESTS, seq: int = LLAVA_SEQ,
                new: int = LLAVA_NEW, cfg=None) -> dict:
    """The vlm serving path: llava-next-mistral-7b at full width and depth
    (bf16, parameters drawn on the card from seed 0), ``batch_n`` requests
    from ``make_batch(cfg, batch_n, seq, 1)`` (at 5760 positions: 2880
    image embeddings, the config's anyres count, and 2880 text tokens),
    ``new`` tokens through ``serve.generate`` (cache of seq + new,
    decode at seq + i).  Prints the prefill time, decode ms/step and
    tokens/s, peak memory and launches (one flash launch a layer); then a
    steady second run, a profiled prefill and decode step split into the
    flash kernel, matmuls and the rest, the projector's time (CUDA events
    around ``embed_inputs`` of the batch: a ``record_function`` range
    around it found no device-side span in one whole-script run), and
    :func:`decode_check` with the prefix mutant.  ``cfg`` replaces the
    config (a CPU rehearsal passes a reduced one)."""
    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model_api

    cfg = cfg or get_config("llava-next-mistral-7b")
    api = get_model_api(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers at full width, "
          f"{api.num_params() / 1e9:.2f} B parameters in {str(cfg.dtype)[6:]}"
          f" ({2 * api.num_params() / 1e9:.1f} GB); {batch_n} requests of "
          f"{seq} positions, {new} new tokens")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    sync(dev)
    print(f"  parameters drawn on the card in {time.perf_counter() - t:.1f} s")
    batch = make_batch(cfg, batch_n, seq, seed=1, device=dev)
    n_img, s = batch["image_feats"].shape[1], batch["tokens"].shape[1]
    print(f"  batch: {n_img} image embeddings of dim {cfg.frontend_dim} and "
          f"{s} text tokens a request")
    zero_counts()  # this serving path's counts start here
    rec = serve.generate(api, params, batch, new)
    launches = read_counts()
    steps = rec["steps"]
    print(f"  prefill {rec['prefill_s']:.4f} s (first call); decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{batch_n * steps / rec['decode_s']:.1f} tokens/s; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(rec["finite"], "llava: a prefill or decode logit is not finite")
    check(rec["n_prefix"] == n_img, f"llava: prefix {rec['n_prefix']}")
    check(tuple(rec["tokens"].shape) == (batch_n, new),
          f"llava: tokens {tuple(rec['tokens'].shape)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"llava: flash launches per prefill {launches['flash_attention']},"
          f" expected {cfg.n_layers}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"llava: other kernels ran on the serving path: {launches}")

    warm = serve.generate(api, params, batch, new)
    print(f"  steady serve.generate: prefill {warm['prefill_s']:.4f} s; decode "
          f"{1e3 * warm['decode_s'] / steps:.2f} ms/step, "
          f"{batch_n * steps / warm['decode_s']:.1f} tokens/s")
    del warm
    with torch.no_grad():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            logits, cache = api.prefill(params, batch, seq + new)
            sync(dev)
            wall = time.perf_counter() - t
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        del logits
        print(f"  profiled prefill {wall:.4f} s:")
        print_split(prof, wall, "prefill")
        proj_ms = timed_ms(lambda: transformer.embed_inputs(params, batch, cfg),
                           dev, 5)
        print(f"  the projector (embed_inputs of the batch: the MLP on "
              f"{n_img} image embeddings a request, and the token lookup) "
              f"{proj_ms:.3f} ms ("
              + ("CUDA events" if dev.type == "cuda" else "host clock")
              + f"), {proj_ms / (10 * wall):.2f}% of the profiled prefill, "
              "within its matmuls and rest")
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            make_serve_step(api)(params, cache, tok, seq)
            sync(dev)
            wall = time.perf_counter() - t
        del cache
    print(f"  profiled decode step {1e3 * wall:.2f} ms:")
    print_split(prof, wall, "decode step")
    del prof
    decode_check(api, params, batch, rec, mutant="prefix")
    return launches


def encoder_path(dev, clips: int = HUBERT_CLIPS, frames: int = HUBERT_FRAMES,
                 cfg=None) -> dict:
    """The masked_lm path: hubert-xlarge at full width and depth (bf16,
    parameters drawn on the card from seed 0) on ``make_batch(cfg, clips,
    frames, 1)``: ``ModelApi.forward`` under ``no_grad``, then
    ``ModelApi.loss`` and ``loss.backward()`` through the flash backward at hd
    80 (one call a layer, each layer's forward recomputed under the
    config's remat), with wall times, frames/s, peak memory, the flash
    launches (all at hd 80, non-causal) and their shape, a finite loss and
    finite gradients; then a steady second forward, profiled and split
    into the flash kernel, matmuls and the rest.  Then the check: the logits
    against the same forward with the attention core swapped to
    ``flash_attention_plain`` (``kernels.ops.flash_attention`` wrapped
    from here; the package has no switch for it), within 2^-4 of
    max|logit|, the tolerance of phase 7's bf16 decode check: both sides
    round every layer's bf16 activations, and the kernel also rounds P to
    bf16 (``bf16_tolerance``) over 48 layers.  The mutant, the same forward
    with ``causal=True``, must miss it.  Returns the launches of the
    forward, the loss and the backward, read once after them (not of the
    profiled forward and the checks).
    ``cfg`` replaces the config (a CPU rehearsal passes a reduced one)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.core.flat import tree_flatten
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import get_model_api

    cfg = cfg or get_config("hubert-xlarge")
    api = get_model_api(cfg)
    hd = cfg.resolved_head_dim
    print(f"  {cfg.name}: {cfg.n_layers} layers at full width, "
          f"{api.num_params() / 1e9:.3f} B parameters in {str(cfg.dtype)[6:]};"
          f" {cfg.n_heads} heads of hd {hd}, causal={cfg.causal}; {clips} "
          f"clips of {frames} frames")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(cfg, clips, frames, seed=1, device=dev)
    leaves = tree_flatten(params)[1]
    sync(dev)
    zero_counts()  # this path's counts start here
    try:
        with kernel_shapes() as seen:
            with torch.no_grad():
                t = time.perf_counter()
                logits, aux = api.forward(params, batch)
                sync(dev)
                fwd_s = time.perf_counter() - t
            for t_ in leaves:
                t_.requires_grad_(True)
            t = time.perf_counter()
            loss, (ce, acc) = api.loss(params, batch)
            sync(dev)
            loss_s = time.perf_counter() - t
            t = time.perf_counter()
            loss.backward()
            sync(dev)
            bwd_s = time.perf_counter() - t
        launches = read_counts()
        loss = float(loss.detach())
        finite = all(bool(torch.isfinite(t_.grad).all()) for t_ in leaves)
        grad_max = max(float(t_.grad.float().abs().max()) for t_ in leaves)
    finally:
        for t_ in leaves:
            t_.requires_grad_(False)
            t_.grad = None
    shapes = sorted(set(seen["flash_attention"]))
    # the forward, the loss's forward, and the loss's again under remat
    fwd_calls = (3 if cfg.remat else 2) * cfg.n_layers
    print(f"  forward {fwd_s:.4f} s (first call), "
          f"{clips * frames / fwd_s:.0f} frames/s; loss {loss:.4f} (ce "
          f"{float(ce):.4f}, acc {float(acc):.4f}) in {loss_s:.4f} s; "
          f"loss.backward() {bwd_s:.4f} s; {len(leaves)} gradients, all "
          f"finite: {finite}, largest |grad| {grad_max:.4e}; flash launches "
          f"{launches['flash_attention']} ({cfg.n_layers} a forward, remat "
          f"{cfg.remat}), {launches['flash_attention_hd80']} of them at hd "
          f"80, shapes (q, k, v) {shapes}; backward calls "
          f"{launches['flash_attention_backward']} "
          f"({launches['flash_attention_backward_hd80']} at hd 80), "
          f"{launches['flash_attention_backward_kernels']} kernels; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(math.isfinite(loss), f"hubert: loss {loss}")
    check(finite, "hubert: a gradient of loss.backward() is not finite")
    if dev.type == "cuda":
        at80 = hd == 80
        want = {"flash_attention": fwd_calls,
                "flash_attention_hd80": fwd_calls if at80 else 0,
                "flash_attention_backward": cfg.n_layers,
                "flash_attention_backward_hd80": cfg.n_layers if at80 else 0}
        check(all(launches[k] == n for k, n in want.items()),
              f"hubert: launches {launches}, expected {want}")
    check(all(v == 0 for k, v in launches.items()
              if not k.startswith("flash_attention")),
          f"hubert: other kernels ran on the encoder path: {launches}")
    with torch.no_grad():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            api.forward(params, batch)
            sync(dev)
            wall = time.perf_counter() - t
    print(f"  profiled steady forward {wall:.4f} s, "
          f"{clips * frames / wall:.0f} frames/s:")
    print_split(prof, wall, "forward")
    del prof

    def plain_core(q, k, v, causal=True, window=0):
        return fa.flash_attention_plain(q, k, v, bool(causal), int(window))

    with torch.no_grad():
        with patched(kops, flash_attention=plain_core):
            want = api.forward(params, batch)[0]
        mutant = get_model_api(dataclasses.replace(cfg, causal=True))
        wrong = mutant.forward(params, batch)[0]
    scale = float(want.float().abs().max())
    tol = 2.0 ** -4 * scale
    err, err_mut = max_err(logits, want), max_err(wrong, want)
    print(f"  check against the plain attention core: max|err| {err:.4e} "
          f"(tolerance {tol:.4e}, 2^-4 of max|logit| {scale:.4e}); causal "
          f"mutant {err_mut:.4e}")
    check(err <= tol, "hubert: the forward disagrees with its plain core")
    check(err_mut > tol, "hubert: the check does not see a causal mask")
    return launches


# -- phase 15: xlstm-350m and hymba-1.5b --------------------------------------

# hymba-1.5b's attention at this phase's prefill: 4 requests of 128 meta
# tokens and 2048 prompt tokens, 25 query heads on 5 kv heads (GQA group 5)
# of hd 64, bf16, causal; 29 of its 32 layers have a 1024-token window.
HYMBA_SHAPE = (4, 25, 5, 2176, 64)
HYMBA_RAGGED = (2, 25, 5, 2131, 64)
# Its training round's attention: one sequence of 128 + 2048 positions.
HYMBA_TRAIN_SHAPE = (1, 25, 5, 2176, 64)
HYMBA_WINDOW = 1024
XLSTM_ARGV = ["--arch", "xlstm-350m", "--no-smoke", "--batch", "4",
              "--prompt-len", "1024", "--new-tokens", "32", "--seed", "0"]
# Prompt tokens of xlstm's f32 check (its prefill is one decode step a
# token, host-bound).
XLSTM_CHECK_TOKENS = 128
HYMBA_ARGV = ["--arch", "hymba-1.5b", "--no-smoke", "--batch", "4",
              "--prompt-len", "2048", "--new-tokens", "32", "--seed", "0"]
# The training CLI's default run (xlstm-350m at full width and depth, 2
# pods, K = 2, 8 x 64 tokens a pod a step), 2 rounds.
XLSTM_TRAIN_ARGV = ["--rounds", "2"]
# hymba-1.5b's training: cut to 4 layers (layer 0 global, 1-3 windowed, as
# hymba's first 4), 1 row of 2048 tokens a pod a step.
HYMBA_TRAIN = (4, 1, 2048)


def hymba_group5():
    """Reduced hymba-1.5b at its GQA group (5 query heads on 1 kv head of
    hd 64, d_model 320): 8 meta tokens, a 32-token window on layer 1."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return reduced(get_config("hymba-1.5b"), n_heads=5, n_kv_heads=1,
                   d_model=320)


def backward_shares(q, kv: int) -> str:
    """How many f32 shares of dK / dV the flash backward sums at q's shape
    (``tc::split_for``): the runs a kv head's query heads are split into."""
    if q.device.type != "cuda":
        return "none on the CPU (the plain backward)"
    from repro_torch.kernels.build import DTYPE_CODES, load_library

    b, h, s, hd = q.shape
    with torch.cuda.device(q.device):
        n = load_library().flash_attention_backward_shares(
            DTYPE_CODES[q.dtype], hd, b, h, kv, s)
    return f"{n} (runs of {h // kv // n} of the group's {h // kv} heads)"


def flash_group5_phase(dev, shape=HYMBA_SHAPE, ragged=HYMBA_RAGGED,
                       train=HYMBA_TRAIN_SHAPE, window=HYMBA_WINDOW,
                       iters: int = 10) -> dict:
    """The flash kernels at hymba-1.5b's shapes, GQA group 5: the forward at
    its prefill (B = 4, 25 on 5 heads, 2176 positions, hd 64, bf16, window
    1024 and 0), at a ragged length (2131, bf16 and f32), each against
    ``flash_attention_plain`` with phase 3's tolerances and a mask one key
    late that must miss them; the backward at its training shape (B = 1,
    window 1024 and 0) against the plain backward with
    ``backward_tolerance`` (given the forward kernel's o and lse, as in
    training), the split ``split_for`` took, and the mask fault.  Then the
    forward's and the backward's times beside their bounds (4 and 10 hd
    FLOP per open pair at the bf16 tensor-core peak) and SDPA's (forward
    and backward, ``enable_gqa``, the same mask).  Returns the times."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(shp, dt, n=3):
        b, h, kv, s, hd = shp
        return [torch.randn(b, c, s, hd, generator=gen, device=dev).to(dt)
                for c in (h, kv, kv, h)[:n]]

    def out_tol(v, want, win):
        if want.dtype == bf16:
            return fa.bf16_tolerance(v, want, True, win)
        return torch.full_like(want, 2e-5, dtype=f32)

    def fault_miss(fault, want, tol):
        return float(((fault[:, :, 1:].float() - want[:, :, :-1].float())
                      .abs() / tol[:, :, :-1]).max())

    for shp, dt, win in ((shape, bf16, window), (shape, bf16, 0),
                         (ragged, bf16, window), (ragged, f32, window)):
        q, k, v = inputs(shp, dt)
        got = fa.flash_attention(q, k, v, True, win)
        want = fa.flash_attention_plain(q, k, v, True, win)
        tol = out_tol(v, want, win)
        sync(dev)
        ratio = float(((got.float() - want.float()).abs() / tol).max())
        miss = fault_miss(fa.flash_attention(torch.roll(q, 1, 2), k, v, True,
                                             win), want, tol)
        print(f"  flash forward (B,H,KV,S,hd)={shp} {str(dt)[6:]} window "
              f"{win}: max|err| {max_err(got, want):.3e}, {ratio:.3f} of its "
              f"tolerance; mask one key late {miss:.1f} of it (must exceed "
              "1)")
        check(ratio <= 1.0, f"flash forward disagrees at group 5 ({shp}, "
                            f"{dt}, {win})")
        check(miss > 1.0, f"the forward tolerance misses a mask fault at "
                          f"group 5 ({shp}, {dt}, {win})")
        del q, k, v, got, want, tol

    for win in (window, 0):
        q, k, v, do = inputs(train, bf16, 4)
        o, lse = fa.flash_attention_with_lse(q, k, v, True, win)
        o_plain = fa.flash_attention_plain(q, k, v, True, win)
        o_tol = out_tol(v, o_plain, win)
        before = fa.backward_kernel_launches
        got = fa.flash_attention_backward(q, k, v, o, do, True, win, lse)
        per_call = fa.backward_kernel_launches - before
        want = fa.flash_attention_backward_plain(q, k, v, o_plain, do, True,
                                                 win)
        tol = fa.backward_tolerance(q, k, v, o_plain, do, want, True, win,
                                    o_err=o_tol)
        sync(dev)
        ratios = [float(((a.float() - b.float()).abs() / t).max())
                  for a, b, t in zip(got, want, tol)]
        roll = [torch.roll(t, 1, 2) for t in (q, o, do, lse)]
        miss = fault_miss(fa.flash_attention_backward(
            roll[0], k, v, roll[1], roll[2], True, win, roll[3])[0],
            want[0], tol[0])
        print(f"  flash backward (B,H,KV,S,hd)={train} bf16 window {win}: "
              f"dq, dk, dv at " + ", ".join(f"{r:.4f}" for r in ratios)
              + f" of the tolerance; {per_call} kernel launches a call; "
              f"dK / dV shares {backward_shares(q, train[2])}; mask one key "
              f"late: dq at {miss:.1f} of the tolerance (must exceed 1)")
        check(max(ratios) <= 1.0, f"flash backward disagrees at group 5 "
                                  f"(window {win})")
        check(miss > 1.0, "the backward tolerance misses a mask fault at "
                          "group 5")
        del q, k, v, do, o, lse, o_plain, o_tol, got, want, tol, roll

    def sdpa(q, k, v, win):
        if not win:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        ar = torch.arange(q.shape[2], device=dev)
        mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :]
                                               < win)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    times = {}
    for win in (window, 0):
        b, h, kv, s, hd = shape
        q, k, v = inputs(shape, bf16)
        pairs = open_pairs(s, True, win)
        bound, by = flash_forward_cost(b, h, kv, s, hd, True, win,
                                       2).bound_ms(BF16_FLOP_PER_S)
        ms = timed_ms(lambda: fa.flash_attention(q, k, v, True, win), dev,
                      iters)
        plain = timed_ms(lambda: fa.flash_attention_plain(q, k, v, True, win),
                         dev, max(iters // 5, 1))
        lib = timed_ms(lambda: sdpa(q, k, v, win), dev, iters)
        times["forward", win] = (ms, bound, plain, lib)
        print(f"  flash forward (B,H,KV,S,hd)={shape} window {win}: {ms:.4f} "
              f"ms, bound {bound:.4f} ms ({by}; {pairs} open pairs a head), "
              f"{100 * bound / ms:.1f}% of it; plain {plain:.4f} ms; SDPA "
              f"{lib:.4f} ms; kernel/SDPA {ms / lib:.3f}")
        del q, k, v
        b, h, kv, s, hd = train
        q, k, v, do = inputs(train, bf16, 4)
        o, lse = fa.flash_attention_with_lse(q, k, v, True, win)
        bound, by = flash_backward_cost(b, h, kv, s, hd, True, win, 2,
                                        lse=True).bound_ms(BF16_FLOP_PER_S)
        ms = timed_ms(lambda: fa.flash_attention_backward(
            q, k, v, o, do, True, win, lse), dev, iters)
        plain = timed_ms(lambda: fa.flash_attention_backward_plain(
            q, k, v, o, do, True, win), dev, max(iters // 5, 1))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = sdpa(qg, kg, vg, win)
        lib = timed_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), dev, iters)
        times["backward", win] = (ms, bound, plain, lib)
        print(f"  flash backward (B,H,KV,S,hd)={train} window {win}: "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of it; plain {plain:.4f} ms; SDPA "
              f"backward {lib:.4f} ms; kernel/SDPA {ms / lib:.3f}")
        del q, k, v, do, o, lse, qg, kg, vg, out
    return times


def xlstm_serving(dev, argv=XLSTM_ARGV, profile_tokens: int = 16,
                  check_tokens: int = XLSTM_CHECK_TOKENS) -> dict:
    """xlstm-350m at full width and depth (24 blocks in 4 groups of [5
    mLSTM, 1 sLSTM], d_model 1024, bf16, parameters drawn on the card)
    through ``serve.main``: 4 prompts of 1024 tokens, 32 new tokens.  Its
    prefill is the reference's: one recurrent decode step a prompt token.
    Prints the prefill seconds, decode ms a step, peak memory and launches
    (no kernel of the table: xLSTM has no attention), a profiled prefill of
    ``profile_tokens`` tokens and a profiled decode step (a whole prefill
    is about a thousand launches a token), and how far ``forward`` (the
    parallel form) in bf16 lies from the logits each new token was picked
    from (printed, not held: see below).

    The check runs on the same weights cast to f32: the recurrent prefill
    of the prompts' first ``check_tokens`` tokens and 7 teacher-forced
    decode steps over the next 7 against ``forward`` over those positions,
    to 2^-6 of max|logit|.  The mLSTM read-out ``sum exp(D) (q.k) v /
    max(|sum exp(D) q.k|, 1)`` divides by a sum of large terms of both
    signs, which amplifies rounding: in bf16 the two forms cannot be held
    to each other at random init (the reference's own bf16 forward and
    prefill differ by 34% of max|logit| at 6 full-width blocks on the CPU,
    3e-5 in f32), and in f32 at full depth the card's two forms measured
    0.19% apart at one of 128 prefill positions (0.014% in decode), the
    mutant 108%.  Beside it the phase prints how far the f32 forward itself
    moves when the weights take 1e-6 relative noise.  The mutant
    decodes the same 8 steps from the f32 prefill's state with a step that
    drops the carried matrix memory (C_new without f_eff C), and must miss.
    Returns the launches."""
    import dataclasses

    from repro_torch.core.flat import tree_map
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import xlstm
    from repro_torch.models.registry import get_model_api

    args = serve.build_parser().parse_args(argv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # this serving path's counts start here
    t = time.perf_counter()
    rec = serve.main(argv + ["--device", dev.type])
    wall = time.perf_counter() - t
    launches = read_counts()
    api, params, batch = rec["api"], rec["params"], rec["batch"]
    cfg, steps, s, n = api.cfg, rec["steps"], args.prompt_len, args.new_tokens
    print(f"  {cfg.name}: {api.num_params()} parameters, {cfg.n_layers} "
          f"blocks {xlstm._groups(cfg)} (mLSTM a group, groups, sLSTM a "
          f"group); serve.main {wall:.1f} s (parameter init included)")
    print(f"  prefill {rec['prefill_s']:.3f} s (first call, "
          f"{1e3 * rec['prefill_s'] / s:.2f} ms a prompt token); decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{args.batch * steps / rec['decode_s']:.1f} tokens/s; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(rec["finite"], "xlstm: a prefill or decode logit is not finite")
    check(tuple(rec["tokens"].shape) == (args.batch, n),
          f"xlstm: tokens {tuple(rec['tokens'].shape)}")
    check(all(v == 0 for v in launches.values()),
          f"xlstm: a kernel of the table ran on its serving path: {launches}")

    prompt = batch["tokens"]
    with torch.no_grad():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            _, cache = api.prefill(params, {"tokens": prompt[:, :profile_tokens]},
                                   profile_tokens)
            sync(dev)
            wall = time.perf_counter() - t
        print(f"  profiled prefill of {profile_tokens} tokens {wall:.3f} s:")
        print_split(prof, wall, "prefill")
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            make_serve_step(api)(params, cache, prompt[:, profile_tokens],
                                 profile_tokens)
            sync(dev)
            wall = time.perf_counter() - t
        print(f"  profiled decode step {1e3 * wall:.2f} ms:")
        print_split(prof, wall, "decode step")
        del prof, cache
        new = rec["tokens"][:, :n - 1].to(prompt.device, prompt.dtype)
        want = api.forward(params, {"tokens": torch.cat([prompt, new], 1)})[0]
        scale = float(want[:, s - 1:].float().abs().max())
        e_bf16 = max_err(rec["logits"], want[:, s - 1:])
        del want
        print(f"  bf16: forward against the logits generate picked its {n} "
              f"tokens from: max|err| {e_bf16:.4e}, {e_bf16 / scale:.3f} of "
              f"max|logit| {scale:.4e} (printed, not held)")

        # The check, in f32 on the same weights.
        api32 = get_model_api(dataclasses.replace(cfg, dtype=torch.float32))
        p32 = tree_map(lambda x: x.float(), params)
        c, m = check_tokens, 8
        toks = prompt[:, :c + m]
        t = time.perf_counter()
        logits, cache = api32.prefill(p32, {"tokens": toks[:, :c]}, c + m)
        steps32 = {k: v.clone() for k, v in cache.items()}
        got = [logits] + [api32.decode_step(p32, steps32, toks[:, c + i],
                                            c + i)[0][:, None]
                          for i in range(m - 1)]
        got = torch.cat(got, 1)
        sync(dev)
        rec_s = time.perf_counter() - t
        want = api32.forward(p32, {"tokens": toks[:, :c + m - 1]})[0]
        gen = torch.Generator(device=dev).manual_seed(21)
        noisy = tree_map(lambda x: x * (1 + 1e-6 * torch.randn(
            x.shape, generator=gen, device=dev)), p32)
        drift = max_err(api32.forward(noisy, {"tokens": toks[:, :c + m - 1]})[0],
                        want)
        del noisy
        real = xlstm.mlstm_step

        def forgetful(state, *qkvif):
            return real((torch.zeros_like(state[0]),) + state[1:], *qkvif)

        with patched(xlstm, mlstm_step=forgetful):
            wrong = torch.stack([api32.decode_step(p32, cache,
                                                   toks[:, c + i], c + i)[0]
                                 for i in range(m - 1)], 1)
        scale = float(want.abs().max())
        tol = 2.0 ** -6 * scale
        e_pre = max_err(got[:, :c], want[:, :c])
        e_dec = max_err(got[:, c:], want[:, c:])
        e_mut = max_err(wrong, want[:, c:])
        del p32, cache, steps32, logits, got, want, wrong
    print(f"  f32 on the same weights: the recurrent prefill of {c} tokens "
          f"and {m - 1} decode steps ({rec_s:.2f} s) against forward: "
          f"prefill max|err| {e_pre:.4e}, decode {e_dec:.4e} (tolerance "
          f"{tol:.4e}, 2^-6 of max|logit| {scale:.4e}); forward's own drift "
          f"under 1e-6 noise on the weights {drift:.4e}; decode steps "
          f"without the carried matrix memory: {e_mut:.4e}")
    check(e_pre <= tol, "xlstm: the recurrent prefill disagrees with forward")
    check(e_dec <= tol, "xlstm: decode disagrees with forward")
    check(e_mut > tol, "xlstm: the decode check does not see its mutant")
    return launches


def ssm_times(dev, api, params, batch) -> None:
    """CUDA-event times of hymba's SSM branch at the prefill's shape: one
    layer's ``_ssm_scan`` (projections, the scan, the read-out) and the
    Hillis-Steele scan alone, beside the time its (B, S, d_inner, N) f32
    operand takes to be read once and written once at the HBM rate."""
    from repro_torch.models import hymba
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _layer

    cfg = api.cfg
    pl = _layer(params["layers"], 0)
    with torch.no_grad():
        x = hymba._with_meta(params, batch["tokens"], cfg, False)
        xn = rms_norm(x, pl["ln1"], cfg.norm_eps)
        branch = timed_ms(lambda: hymba._ssm_scan(pl["ssm"], xn, cfg), dev, 3,
                          1)
        _, _, decay, Bm, _, u = hymba._ssm_proj(pl["ssm"], xn, cfg)
        contrib = u[..., None] * Bm[:, :, None, :]
        scan = timed_ms(lambda: hymba._scan(decay, contrib), dev, 3, 1)
        touch = (2 * contrib.numel() + decay.numel()) * 4 / HBM_BYTES_PER_S
    passes = (x.shape[1] - 1).bit_length()
    print(f"  hymba's SSM branch over {tuple(x.shape[:2])} positions: "
          f"{branch:.3f} ms a layer ({cfg.n_layers * branch:.1f} ms for "
          f"{cfg.n_layers} layers), the scan alone {scan:.3f} ms ({passes} "
          f"passes over {tuple(contrib.shape)} f32; read and written once at "
          f"the HBM rate: {touch * 1e3:.3f} ms)")


def hymba_serving(dev, argv=HYMBA_ARGV) -> dict:
    """hymba-1.5b at full width and depth (32 layers, 25 on 5 heads of hd 64
    beside the SSM heads, 128 meta tokens, windows 1024 except layers 0, 15
    and 31; bf16, parameters drawn on the card) through ``serve.main``: 4
    prompts of 2048 tokens (2176 positions with the meta tokens), 32 new
    tokens.  Prints the prefill seconds, decode ms a step, peak memory and
    launches (one flash launch a layer: 32), a profiled prefill and decode
    step split by kind, the SSM branch's time (:func:`ssm_times`), and how
    far ``forward`` in bf16 lies from the logits each new token was picked
    from (printed, not held).  The decode check (:func:`decode_check`,
    with the meta-offset mutant) runs ``serve.generate`` again on the same
    weights and prompts cast to f32, held to 2^-6 of max|logit|: in bf16
    the model's own decode and forward drift apart with depth and length at
    random init (the reference's own bf16 decode path and forward differ by
    4.2% of max|logit| at 12 full-width layers and 256 positions on the CPU,
    1.5% at 4 layers, as the port's do; the port and the reference differ
    by 14.7% on the same forward), which no bf16 tolerance separates from a
    fault.  Returns the launches."""
    import dataclasses

    from repro_torch.core.flat import tree_map
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import get_model_api

    args = serve.build_parser().parse_args(argv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # this serving path's counts start here
    t = time.perf_counter()
    rec = serve.main(argv + ["--device", dev.type])
    wall = time.perf_counter() - t
    launches = read_counts()
    api, params, batch = rec["api"], rec.pop("params"), rec["batch"]
    cfg, steps, s, n = api.cfg, rec["steps"], args.prompt_len, args.new_tokens
    print(f"  {cfg.name}: {api.num_params()} parameters, {cfg.n_layers} "
          f"layers, windows "
          f"{sorted(set(cfg.window_for_layer(i) for i in range(cfg.n_layers)))}"
          f"; serve.main {wall:.1f} s (parameter init included)")
    print(f"  prefill {rec['prefill_s']:.3f} s (first call); decode "
          f"{1e3 * rec['decode_s'] / steps:.2f} ms/step, "
          f"{args.batch * steps / rec['decode_s']:.1f} tokens/s; launches "
          f"{launches}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    check(rec["finite"], "hymba: a prefill or decode logit is not finite")
    check(tuple(rec["tokens"].shape) == (args.batch, n),
          f"hymba: tokens {tuple(rec['tokens'].shape)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"hymba: flash launches per prefill {launches['flash_attention']}, "
          f"expected {cfg.n_layers}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"hymba: other kernels ran on the serving path: {launches}")
    with torch.no_grad():
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            logits, cache = api.prefill(params, batch, s + n)
            sync(dev)
            wall = time.perf_counter() - t
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        del logits
        print(f"  profiled prefill {wall:.3f} s:")
        print_split(prof, wall, "prefill")
        with torch.profiler.profile() as prof:
            t = time.perf_counter()
            make_serve_step(api)(params, cache, tok, s)
            sync(dev)
            wall = time.perf_counter() - t
        del cache
    print(f"  profiled decode step {1e3 * wall:.2f} ms:")
    print_split(prof, wall, "decode step")
    del prof
    ssm_times(dev, api, params, batch)
    with torch.no_grad():
        new = rec["tokens"][:, :n - 1].to(batch["tokens"].device,
                                            batch["tokens"].dtype)
        want = api.forward(params, {"tokens": torch.cat(
            [batch["tokens"], new], 1)})[0][:, s - 1:]
        scale = float(want.float().abs().max())
        e_bf16 = max_err(rec["logits"], want)
        del want
    print(f"  bf16: forward against the logits generate picked its {n} "
          f"tokens from: max|err| {e_bf16:.4e}, {e_bf16 / scale:.3f} of "
          f"max|logit| {scale:.4e} (printed, not held)")
    del rec
    api32 = get_model_api(dataclasses.replace(cfg, dtype=torch.float32))
    p32 = tree_map(lambda x: x.float(), params)
    del params
    release()
    print("  f32 on the same weights and prompts:")
    rec32 = serve.generate(api32, p32, batch, n)
    decode_check(api32, p32, batch, rec32, mutant="meta", rel=2.0 ** -6)
    return launches


def cli_training(dev, argv) -> dict:
    """The training CLI's run: ``launch.train.main(argv)``.  Prints each
    round's loss, w_mass and wall time, peak memory and the launches (one
    dense mix a round; xlstm-350m, the default, has no attention).  The
    loss must be finite and the mass 2 within 1e-3.  Returns the
    launches."""
    from repro_torch.launch import train

    argv = argv + ([] if "--device" in argv or dev.type == "cuda"
                   else ["--device", dev.type])
    rounds = train.build_parser().parse_args(argv).rounds
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()  # this training path's counts start here
    t = time.perf_counter()
    rec = train.main(argv)
    wall = time.perf_counter() - t
    launches = read_counts()
    api = rec["api"]
    print(f"  {api.cfg.name}, {api.cfg.n_layers} layers: {api.num_params()} "
          f"parameters a replica; train.main {wall:.1f} s (parameter init "
          f"included); launches {launches}")
    for h in rec["history"]:
        print(f"  round {h['round']}: loss {h['loss']:.4f} acc {h['acc']:.4f} "
              f"w_mass {h['w_mass']:.6f} wall {h['dt']:.3f} s")
        check(math.isfinite(h["loss"]), f"round {h['round']}: loss "
                                        f"{h['loss']}")
        check(abs(h["w_mass"] - train.N_PODS) <= 1e-3,
              f"round {h['round']}: w_mass {h['w_mass']}")
    check(len(rec["history"]) == rounds, f"{len(rec['history'])} rounds")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    if dev.type == "cuda":
        check(launches["gossip_matmul"] == rounds and all(
            n == 0 for k, n in launches.items() if k != "gossip_matmul"),
            f"{api.cfg.name} training: launches {launches}, expected "
            f"{rounds} dense mixes")
    return launches


def backward_passes(shape, dt=torch.bfloat16) -> int:
    """The kernels one flash backward call launches at ``shape`` (B, H, KV,
    S, hd) given the forward's logsumexp: D, dK / dV, the shares' sum
    where the group is split (:func:`backward_shares`), dQ."""
    from repro_torch.kernels.build import DTYPE_CODES, load_library

    b, h, kv, s, hd = shape
    shares = load_library().flash_attention_backward_shares(
        DTYPE_CODES[dt], hd, b, h, kv, s)
    return 3 + (shares > 1)


def backward_symbols(prof) -> dict:
    """{(pass, hd): launches} of the tensor-core backward's dK / dV and dQ
    kernels in a profile, read from the kernels' symbols
    (``tc::flash_bwd_dkdv_kernel<256>``, demangled or mangled), and under
    ("simt", 0) the SIMT passes' launches."""
    import re

    out = {}
    for e in prof.key_averages():
        m = (re.search(r"tc::flash_bwd_(dkdv|dq)_kernel<(\d+)>", e.key)
             or re.search(r"2tc\d+flash_bwd_(dkdv|dq)_kernelILi(\d+)E", e.key))
        if m:
            key = (m.group(1), int(m.group(2)))
        elif re.search(r"flash_bwd_(dkdv|dq)_kernel", e.key):
            key = ("simt", 0)
        else:
            continue
        out[key] = out.get(key, 0) + e.count
    return out


def pod_training(dev, arch: str, layers, batch_n: int, seq: int, shape,
                 rounds: int = 2, cfg=None, profile: bool = True) -> dict:
    """The pods-as-clients round of ``arch`` on the card through the
    port's ``launch/steps.make_round_step``, as ``launch.train.run`` drives
    it: full width (bf16, parameters drawn on the card from seed 0, the
    replicas equal), its depth cut to ``layers`` where given, 2 pods, K =
    2, lr 0.05, alpha 0.9, rho 0.05, the dense ``P_pod``, ``batch_n`` rows
    of ``seq`` positions a pod a step (:func:`round_batches`: the lm
    stream, or the task's ``make_batch`` draws).  ``shape`` is (B, H, KV,
    S, hd) of its attention.  Per round: loss, accuracy, w_mass, wall time
    and the launches by kernel; then peak memory and a profiled round
    split by kind.  The losses must be finite, w_mass 2 within 1e-3, and
    each round one dense mix and 2 passes x K x 2 pods x layers flash
    backward calls at ``shape`` (twice as many forward launches under
    remat), each launching :func:`backward_passes` kernels, at hd 80 and
    256 all of them on that head dim's kernels; at hd 256 the profiled
    round's kernel symbols must show one ``tc::`` dK / dV and one dQ launch
    a call and no SIMT pass (:func:`backward_symbols`).  ``cfg`` replaces
    the config (a CPU rehearsal passes a reduced one).  Returns the
    launches."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    cfg = cfg or get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_model_api(cfg)
    k_steps, n_pods = 2, 2
    step_cfg = steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05,
                                local_steps=k_steps)
    round_step = steps.make_round_step(api, step_cfg)
    hd = cfg.resolved_head_dim
    print(f"  {cfg.name}: {cfg.n_layers} layers at full width, "
          f"{api.num_params() / 1e9:.3f} B parameters a replica in "
          f"{str(cfg.dtype)[6:]}, {cfg.n_heads} heads on {cfg.n_kv_heads} of "
          f"hd {hd}, causal={cfg.causal}, remat {cfg.remat}; {n_pods} pods, "
          f"K = {k_steps}, {batch_n} x {seq} positions a pod a step")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
        params = tree_map(lambda x: x.unsqueeze(0).expand(
            (n_pods,) + x.shape).contiguous(), params)
    v = tree_map(torch.zeros_like, params)
    w = torch.ones(n_pods, dtype=torch.float32, device=dev)
    P = steps.pod_mixing_matrix(n_pods, dev)
    data = round_batches(cfg, rounds, batch_n, seq, k_steps, device=dev)
    sync(dev)
    print(f"  parameters, momentum and batches on the card in "
          f"{time.perf_counter() - t:.1f} s; a step's batch: " + ", ".join(
              f"{k} {tuple(x.shape[3:])}" for k, x in data.items()))
    per_round = 2 * k_steps * n_pods * cfg.n_layers  # 2 SAM passes
    want = {"flash_attention_backward": per_round,
            "flash_attention_backward_hd80": per_round if hd == 80 else 0,
            "flash_attention_backward_hd256": per_round if hd == 256 else 0,
            "flash_attention": per_round * (2 if cfg.remat else 1),
            "gossip_matmul": 1, "gossip_gather": 0, "fused_update_bank": 0}
    if dev.type == "cuda":
        want["flash_attention_backward_kernels"] = (
            per_round * backward_passes(shape))
    b, h, kv, s, _ = shape
    qkv = ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd))
    zero_counts()  # this training path's counts start here
    last = read_counts()
    with kernel_shapes() as seen:
        for r in range(rounds):
            t = time.perf_counter()
            params, v, w, _, _, m = round_step(
                params, v, w, (), (), {k: x[r] for k, x in data.items()}, P)
            loss, acc = float(m["loss"]), float(m["acc"])
            w_mass = float(w.sum())
            sync(dev)
            wall = time.perf_counter() - t
            now = read_counts()
            used = {k: now[k] - last[k] for k in now}
            last = now
            calls = max(used["flash_attention_backward"], 1)
            print(f"  round {r}: loss {loss:.4f} acc {acc:.4f} w_mass "
                  f"{w_mass:.6f} wall {wall:.3f} s; launches {used}; "
                  f"{used['flash_attention_backward_kernels'] / calls:g} "
                  "backward kernels a call", flush=True)
            check(math.isfinite(loss), f"{cfg.name} round {r}: loss {loss}")
            check(abs(w_mass - n_pods) <= 1e-3,
                  f"{cfg.name} round {r}: w_mass {w_mass}")
            if dev.type == "cuda":
                check(all(used[k] == n for k, n in want.items()),
                      f"{cfg.name} round {r}: launches {used}, expected "
                      f"{want}")
    launches = read_counts()
    if dev.type == "cuda":
        check(set(seen["flash_attention"]) == {qkv},
              f"{cfg.name}: flash shapes {set(seen['flash_attention'])}, "
              f"expected {qkv}")
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB)")
    if profile:  # the device's events only: a round holds ~10^5 host ops
        kinds = ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
                 else None)
        with torch.profiler.profile(activities=kinds) as prof:
            t = time.perf_counter()
            round_step(params, v, w, (), (),
                       {k: x[0] for k, x in data.items()}, P)
            sync(dev)
            wall = time.perf_counter() - t
        print(f"  profiled round {wall:.3f} s:")
        print_train_split(prof, wall)
        if dev.type == "cuda" and hd == 256:
            syms = backward_symbols(prof)
            print(f"  flash backward kernels by symbol in the profiled round: "
                  f"{syms}")
            check(syms == {("dkdv", 256): per_round, ("dq", 256): per_round},
                  f"{cfg.name}: backward kernels {syms}, expected "
                  f"{per_round} tc::flash_bwd_dkdv_kernel<256> and "
                  f"tc::flash_bwd_dq_kernel<256>")
        del prof
    return launches


def blocks_phase(dev, head=print) -> dict:
    """Phase 15 whole (``head`` prints each step's heading): the flash
    kernels at group 5, the reduced parities, both models served at full
    width, and both trained.  Returns the launches of its four main paths.
    ``python3 repeat_phase.py --repeat 1 blocks_phase`` runs it alone."""
    card = card_line() if dev.type == "cuda" else "no card"
    paths = {}
    head(f"[15] xlstm-350m and hymba-1.5b: the flash kernels at hymba's GQA "
         f"group 5; card: {card}")
    flash_group5_phase(dev)
    release()
    for arch in ("xlstm-350m", "hymba-1.5b"):
        head(f"[15] reduced {arch}, card against CPU, f32")
        serving_parity(dev, arch)
    head("[15] reduced hymba-1.5b at GQA group 5 (5 on 1 heads), card "
         "against CPU, f32")
    serving_parity(dev, "hymba-1.5b", cfg=hymba_group5())
    for arch, cfg in (("xlstm-350m", None), ("hymba-1.5b", hymba_group5())):
        head(f"[15] training: reduced {arch}, 2 pods, card against CPU, f32")
        train_parity(dev, seq=64, arch=arch, cfg=cfg,
                     calibrate=arch == "xlstm-350m")
    head(f"[15] xlstm-350m at full width and depth, bf16, 4 x 1024 tokens; "
         f"card: {card}")
    paths["xlstm-350m serving path"] = xlstm_serving(dev)
    release()
    head(f"[15] hymba-1.5b at full width and depth, bf16, 4 x 2048 tokens; "
         f"card: {card}")
    paths["hymba-1.5b serving path"] = hymba_serving(dev)
    release()
    head(f"[15] training: the CLI's default (xlstm-350m at full width and "
         f"depth), 2 rounds; card: {card}")
    paths["xlstm-350m training path"] = cli_training(dev, XLSTM_TRAIN_ARGV)
    release()
    layers, batch_n, seq = HYMBA_TRAIN
    head(f"[15] training: hymba-1.5b at full width cut to {layers} layers, "
         f"2 pods, K = 2, {batch_n} x {seq} tokens, 2 rounds; card: {card}")
    paths["hymba-1.5b training path"] = pod_training(
        dev, "hymba-1.5b", layers, batch_n, seq, HYMBA_TRAIN_SHAPE)
    release()
    return paths


# -- phase 16: pods-as-clients training of the masked_lm and vlm tasks ---------

# Each model, its depth (None: all of it), its rows a pod a step and their
# positions: hubert-xlarge whole, 2 clips of 1500 frames (phase 14's 30 s
# clip); llava-next-mistral-7b cut to 4 of its 32 layers (2 replicas,
# momentum, the SAM copies and the f32 bank fit the card, as glm4-9b in
# phase 12), 1 x (2880 image embeddings + 2880 text tokens).
TASK_TRAIN = {"hubert-xlarge": (None, 2, 1500, HUBERT_TRAIN_SHAPE),
              "llava-next-mistral-7b": (4, 1, 5760, LLAVA_TRAIN_SHAPE)}
TASK_ROUNDS = 2


def tasks_phase(dev, head=print) -> dict:
    """Phase 16 whole (``head`` prints each step's heading): for the
    masked_lm and the vlm task, a reduced pod round in f32, card against
    CPU (hubert-xlarge at d_model 320 keeps 4 heads of hd 80, so its card
    side runs the f32 SIMT backward at hd 80), then the model at full
    width (:data:`TASK_TRAIN`) through :func:`pod_training`.  Returns the
    launches of its two main paths.  ``python3 repeat_phase.py --repeat 1
    tasks_phase`` runs it alone."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    card = card_line() if dev.type == "cuda" else "no card"
    paths = {}
    reduced = {"hubert-xlarge": dataclasses.replace(
        get_config("hubert-xlarge", smoke=True), d_model=320),
        "llava-next-mistral-7b": None}
    for arch, cfg in reduced.items():
        head(f"[16] training: reduced {arch}, 2 pods, card against CPU, f32")
        train_parity(dev, arch=arch, cfg=cfg)
    for arch, (layers, batch_n, seq, shape) in TASK_TRAIN.items():
        depth = "and depth" if layers is None else f"cut to {layers} layers"
        head(f"[16] training: {arch} at full width {depth}, 2 pods, K = 2, "
             f"{batch_n} x {seq} positions, {TASK_ROUNDS} rounds; card: "
             f"{card}")
        paths[f"{arch} training path"] = pod_training(
            dev, arch, layers, batch_n, seq, shape, TASK_ROUNDS)
        release()
    return paths


# -- phase 17: personalized lanes of every family -------------------------------

# Full width, personalized: (layers kept, None for all; lanes; text tokens,
# prompt tokens or frames a lane; f32 weights).  llava-next-mistral-7b's
# lanes carry its 2880 image embeddings (the config's anyres count) before
# 1024 text tokens, hymba-1.5b's its 128 meta tokens before 1024;
# hubert-xlarge encodes 1500 frames a lane (``forward``: an encoder has no
# decode).  deepseek-v3-671b takes one lane: its base at one layer (26.7 GB
# in bf16) and one expanded copy fit 80 GB, two copies do not.  xlstm and
# hymba run on f32 weights: in bf16 their two forms drift apart at random
# init (phase 15).
LANES_FULL = {"llava-next-mistral-7b": (None, 2, 1024, False),
              "dbrx-132b": (2, 2, 2048, False),
              "deepseek-v3-671b": (1, 1, 2048, False),
              "hymba-1.5b": (None, 2, 1024, True),
              "xlstm-350m": (None, 2, 128, True),
              "hubert-xlarge": (None, 2, 1500, False)}
LANES_RANK, LANES_NEW = 8, 16


def flash_layers(cfg) -> int:
    """Flash launches of one prefill or forward: one a GQA layer (MLA and
    xLSTM have none)."""
    return (cfg.n_layers if cfg.attn_type == "gqa"
            and cfg.block_kind != "xlstm" else 0)


def lanes_parity(dev, arch: str) -> None:
    """Reduced ``arch`` in f32 (as :func:`serving_parity`; hubert-xlarge
    at hd 80, as :func:`encoder_parity`), personalized: a rank-2 delta bank of 3 clients (0.02 standard normals,
    w in [0.5, 1.5)) over the drawn base, the lanes in the permuted client
    order (2, 0, 1), each device expanding the same bank over its own copy
    of the base; the lanes' prefill of 64 positions and 3 greedy decode
    steps (hubert: its laned ``forward``) on ``dev`` against
    the same on the CPU.  Logits within 1e-4 of their magnitude, greedy
    tokens equal; the MoE models at ``capacity_factor = n_experts /
    top_k`` (every token kept, so that a choice flipped between the two
    sides' sums changes no other token's).  The card launches the flash
    kernel once a GQA layer, the lanes as its batch."""
    import dataclasses

    from repro_torch.configs.registry import get_config, make_batch
    from repro_torch.core.flat import bind_delta_spec, make_delta_spec, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_personalized_serve_step
    from repro_torch.models.registry import get_model_api

    s, steps = 64, 3
    cfg = get_config(arch, smoke=True)
    if cfg.task == "masked_lm":
        cfg = dataclasses.replace(cfg, d_model=320)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    api = get_model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    dspec = make_delta_spec(params, rank=2)
    gen = torch.Generator().manual_seed(3)
    bank = 0.02 * torch.randn((3, dspec.dim), generator=gen)
    w = 0.5 + torch.rand((3,), generator=gen)
    ids = torch.tensor([2, 0, 1])
    batch = make_batch(cfg, 3, s, seed=1)
    runs = {}
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda t, d=d: t.to(d), params)
        ps = make_personalized_serve_step(api, bind_delta_spec(dspec, p))
        b = {k: v.to(d) for k, v in batch.items()}
        before = fa.launches
        with torch.no_grad():
            stacked = ps.expand(bank.to(d), w.to(d), ids.to(d))
            toks = []
            if not cfg.supports_decode():
                out = [api.forward(stacked, b)[0].cpu()]
            else:
                logits, cache = ps.prefill(stacked, b, s + steps + 1)
                out = [logits.cpu()]
                tok = logits[:, -1].argmax(-1).to(torch.int32)
                for i in range(steps):
                    toks.append(tok.cpu())
                    logits, cache = ps.decode_step(stacked, cache, tok, s + i)
                    out.append(logits.cpu())
                    tok = logits.argmax(-1).to(torch.int32)
                toks.append(tok.cpu())
        runs[d.type] = (out, toks, fa.launches - before)
    (want, want_toks, _), (got, got_toks, used) = runs["cpu"], runs[dev.type]
    errs = []
    for i, (g, x) in enumerate(zip(got, want)):
        e, tol = max_err(g, x), 1e-4 * float(x.abs().max())
        errs.append(e / tol)
        check(e <= tol, f"{arch} lanes: card and CPU logits disagree ({i})")
    check(all(torch.equal(a, b) for a, b in zip(got_toks, want_toks)),
          f"{arch} lanes: card and CPU greedy tokens differ")
    flash = flash_layers(cfg)
    print(f"  reduced {arch}, 3 lanes x {s} positions"
          + (f", {steps} decode steps" if cfg.supports_decode()
             else " (forward)")
          + f": logits {tuple(got[0].shape)} at most {max(errs):.4f} of the "
          f"tolerance (1e-4 of max|logit|)"
          + ("; greedy tokens equal" if toks else "")
          + f"; flash launches on the card {used} (one a GQA layer: "
          f"{flash})")
    if dev.type == "cuda":
        check(used == flash, f"{arch} lanes: flash launches {used}")


def lanes_batch(cfg, n: int, seq: int, dev) -> dict:
    """``make_batch``'s draw of ``n`` lanes of ``seq`` positions; a vlm's
    lanes carry the config's ``n_frontend_tokens`` image embeddings before
    ``seq`` text tokens."""
    from repro_torch.configs.registry import make_batch

    if cfg.task != "vlm":
        return make_batch(cfg, n, seq, seed=1, device=dev)
    batch = make_batch(cfg, n, 2 * cfg.n_frontend_tokens, seed=1, device=dev)
    batch["tokens"] = batch["tokens"][:, :seq].contiguous()
    return batch


def lanes_flash_check(dev, cfg, n: int, positions: int) -> None:
    """The flash forward at the lanes' attention shape, the ``n`` lanes as
    its batch: ``(n, H, positions, hd)`` q on ``(n, KV, positions, hd)``
    k, v, random, in the model's dtype (the f32 SIMT kernel for f32
    weights), under each mask the model's layers pass it (causal with each
    of their windows; non-causal for an encoder), against
    ``flash_attention_plain`` on the same inputs: within
    ``bf16_tolerance`` in bf16 and 2e-5 in f32, as in phase 3.  A mask one
    key late must miss that tolerance: q moved down one row where the mask
    is causal, each row's last key left out where it is not.  These
    launches come before the path's counts start."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import _layer_meta

    gen = torch.Generator(device=dev).manual_seed(17)
    hd, dt, causal = cfg.resolved_head_dim, cfg.dtype, cfg.causal
    q, k, v = [torch.randn(n, h, positions, hd, generator=gen,
                           device=dev).to(dt)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    for win in sorted(set(_layer_meta(cfg)[0])) if causal else [0]:
        got = fa.flash_attention(q, k, v, causal, win)
        want = fa.flash_attention_plain(q, k, v, causal, win)
        tol = (fa.bf16_tolerance(v, want, causal, win)
               if dt == torch.bfloat16
               else torch.full_like(want, 2e-5, dtype=torch.float32))
        ratio = float(((got.float() - want.float()).abs() / tol).max())
        del got
        if causal:
            fault = fa.flash_attention(torch.roll(q, 1, 2), k, v, True,
                                       win)[:, :, 1:]
        else:
            fault = fa.flash_attention(q[:, :, :-1], k[:, :, :-1],
                                       v[:, :, :-1], False, 0)
        miss = float(((fault.float() - want[:, :, :-1].float()).abs()
                      / tol[:, :, :-1]).max())
        del fault, want, tol
        print(f"  flash forward at the lanes' shape q {tuple(q.shape)}, k, v "
              f"{tuple(k.shape)}, {str(dt)[6:]}, "
              + (f"causal, window {win}" if causal else "non-causal")
              + f": {ratio:.3f} of its tolerance against the plain version; "
              f"mask one key late {miss:.1f} of it (must exceed 1)")
        check(ratio <= 1.0, f"flash forward disagrees at the lanes' shape "
                            f"{tuple(q.shape)} (window {win})")
        check(miss > 1.0, f"the lanes' flash check misses a mask fault at "
                          f"{tuple(q.shape)} (window {win})")


def lanes_serving(dev, arch: str, layers, n: int, seq: int, f32: bool,
                  new: int = LANES_NEW, cfg=None) -> dict:
    """Personalized serving of ``arch`` at full width (its depth cut to
    ``layers`` where given, f32 weights if ``f32``, else the config's
    bf16; parameters drawn on the card from seed 0): first
    :func:`lanes_flash_check` at the lanes' attention shape where the
    model has GQA layers; then ``serve.main --clients``' delta bank of
    ``n`` clients at rank ``LANES_RANK`` over the drawn
    base (``serve.client_bank``: lane 0 a zero row with w = 1 when ``n`` >
    1, the other rows random), expanded by ``make_personalized_serve_step``
    and served through ``serve.generate`` (``new`` new tokens; hubert: its
    laned ``forward``).  The counts run from just before the expansion to
    just after the serve: one flash launch a GQA layer of the prefill, its
    (q, k, v) shapes with the lanes as the batch, no FL kernel.  Prints
    expand s and its peak memory, prefill s, decode ms/step and the peak.

    Then, as phase 11: lane 0 against the dense ``serve.generate`` of the
    base on its request; lane 1 against ``forward`` of its own expanded
    weights on its extended prompt (:func:`decode_check`; a MoE model
    through :func:`moe_decode_check`, its routing pinned to the served
    path's, at the config's own capacity), both within 2^-4 of max|logit|
    in bf16 and 2^-6 in f32; lane 0's logits held against lane 1's forward
    must miss.  With one lane (deepseek-v3-671b) its logits against the
    forward of its expanded weights, and the base's forward must miss.
    hubert: each lane's laned logits against ``forward`` of that lane's
    weights alone on its frames, lane 0's against lane 1's weights
    (swapped) must miss.  ``cfg`` replaces the config (a CPU rehearsal
    passes a reduced one).  Returns the launches."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_personalized_serve_step
    from repro_torch.models.registry import get_model_api

    full = cfg or get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    api = get_model_api(cfg)
    cuda, decode = dev.type == "cuda", cfg.supports_decode()
    rel = 2.0 ** -6 if f32 else 2.0 ** -4
    batch = lanes_batch(cfg, n, seq, dev)
    n_prefix = batch["image_feats"].shape[1] if "image_feats" in batch else 0
    inputs = batch["tokens" if decode else "features"].shape[1]
    positions = n_prefix + cfg.n_meta_tokens + inputs
    flash = flash_layers(cfg)
    if flash:
        lanes_flash_check(dev, cfg, n, positions)
    t = time.perf_counter()
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    sync(dev)
    init_s = time.perf_counter() - t
    spec, bank, w = serve.client_bank(params, n, LANES_RANK, int(n > 1),
                                      seed=0)
    ps = make_personalized_serve_step(api, spec)
    print(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers at full width, "
          f"{api.num_params() / 1e9:.3f} B parameters in {str(cfg.dtype)[6:]} "
          f"(drawn in {init_s:.1f} s); {n} lane(s) of "
          + (f"{n_prefix} image embeddings + " if n_prefix else "")
          + (f"{cfg.n_meta_tokens} meta tokens + " if cfg.n_meta_tokens
             else "")
          + f"{seq} {'frames' if not decode else 'tokens'}; rank "
          f"{LANES_RANK}, "
          f"d_delta {spec.dim} ({100 * spec.dim / spec.delta.full.dim:.2f}% "
          f"of D); lane 0 " + ("a zero row" if n > 1 else "a random row"))
    resident = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sels = []
    zero_counts()  # this lanes path's counts start here
    with kernel_shapes() as shapes, recorded_routing(sels):
        sync(dev)
        t = time.perf_counter()
        with torch.no_grad():
            stacked = ps.expand(bank, w, torch.arange(n, device=dev))
        sync(dev)
        expand_s = time.perf_counter() - t
        if cuda:
            expand_peak = torch.cuda.max_memory_allocated() - resident
            lanes_bytes = torch.cuda.memory_allocated() - resident
        if decode:
            rec = serve.generate(api, stacked, batch, new)
        else:
            t = time.perf_counter()
            with torch.no_grad():
                logits = api.forward(stacked, batch)[0]
            sync(dev)
            fwd_s = time.perf_counter() - t
    launches = read_counts()
    line = f"  expand {expand_s:.4f} s"
    if cuda:
        rows = bank.numel() * bank.element_size()
        line += (f" (peak {expand_peak / 1e9:.2f} GB over the resident base's "
                 f"{resident / 1e9:.2f} GB: the lanes {lanes_bytes / 1e9:.2f} "
                 f"GB, the gathered bank rows {rows / 1e9:.2f} GB and "
                 f"{(expand_peak - lanes_bytes - rows) / 1e9:.2f} GB of "
                 "expansion temporaries)")
    if decode:
        line += (f"; prefill {rec['prefill_s']:.4f} s (first call); decode "
                 f"{1e3 * rec['decode_s'] / rec['steps']:.2f} ms/step")
    else:
        line += f"; laned forward {fwd_s:.4f} s (first call)"
    print(line)
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2 ** 30:.2f} GiB); launches {launches}")
    hd = cfg.resolved_head_dim
    check(launches["flash_attention"] == flash,
          f"{arch} lanes: flash launches {launches['flash_attention']}, "
          f"expected {flash}")
    check(launches["flash_attention_hd80"] == (flash if hd == 80 else 0),
          f"{arch} lanes: hd 80 launches {launches['flash_attention_hd80']}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("flash_attention", "flash_attention_hd80")),
          f"{arch} lanes: the FL kernels ran on the lanes path: {launches}")
    if flash:
        want_q = (n, cfg.n_heads, positions, hd)
        want_kv = (n, cfg.n_kv_heads, positions, hd)
        check(set(shapes["flash_attention"]) == {(want_q, want_kv, want_kv)},
              f"{arch} lanes: flash shapes {set(shapes['flash_attention'])}")
        print(f"  flash (q, k, v) shapes on every layer: {want_q}, {want_kv}, "
              f"{want_kv}")

    lane = [tree_map(lambda x, b=b: x[b], stacked) for b in range(n)]
    if not decode:
        check(bool(torch.isfinite(logits).all()),
              f"{arch} lanes: a logit is not finite")
        with torch.no_grad():
            alone = [api.forward(lane[b], {k: v[b:b + 1] for k, v in
                                           batch.items()})[0]
                     for b in range(n)]
            swapped = api.forward(lane[1], {k: v[:1] for k, v in
                                            batch.items()})[0]
        for b in range(n):
            e, scale = max_err(logits[b:b + 1], alone[b]), float(
                alone[b].float().abs().max())
            print(f"  lane {b}'s laned logits against its weights' forward "
                  f"alone: max|err| {e:.4e} (tolerance {rel * scale:.4e})")
            check(e <= rel * scale, f"{arch}: lane {b} disagrees")
        e = max_err(logits[:1], swapped)
        tol = rel * float(alone[0].float().abs().max())
        print(f"  lane 0's logits against lane 1's weights on lane 0's frames:"
              f" {e:.4e} (must exceed {tol:.4e})")
        check(e > tol, f"{arch}: the lane check does not tell the lanes apart")
        return launches

    check(rec["finite"], f"{arch} lanes: a prefill or decode logit is not "
                         "finite")
    check(tuple(rec["tokens"].shape) == (n, new),
          f"{arch} lanes: tokens {tuple(rec['tokens'].shape)}")
    s = batch["tokens"].shape[1]
    last = n - 1  # the lane held against its own forward: a random row
    rows = {k: v[last:last + 1] for k, v in batch.items()}
    one = {"logits": rec["logits"][last:last + 1],
           "tokens": rec["tokens"][last:last + 1]}
    if cfg.n_experts:
        tol = moe_decode_check(api, lane[last], rows, one,
                               [x[last:last + 1] for x in sels],
                               mutant="layer" if cfg.n_layers > 1 else None)
    else:
        tol = decode_check(api, lane[last], rows, one, mutant=None, rel=rel)
    new_t = rec["tokens"][last:last + 1, :-1].to(batch["tokens"].device,
                                                 batch["tokens"].dtype)
    ext = dict(rows, tokens=torch.cat([rows["tokens"], new_t], 1))
    with torch.no_grad():
        fwd = api.forward(spec.base if n == 1 else lane[last],
                          ext)[0][:, n_prefix + s - 1:]
    if n == 1:
        e = max_err(one["logits"], fwd)
        print(f"  the lane's logits against the base's forward on its "
              f"extended prompt: {e:.4e} (must exceed {tol:.4e})")
        check(e > tol, f"{arch}: the lane serves the base")
        return launches
    e = max_err(rec["logits"][:1], fwd)
    print(f"  lane 0's logits against lane {last}'s forward: {e:.4e} (must "
          f"exceed {tol:.4e})")
    check(e > tol, f"{arch}: the lane check does not tell the lanes apart")
    del fwd
    dense = serve.generate(api, spec.base, {k: v[:1] for k, v in
                                           batch.items()}, new)
    got, want = rec["logits"][0], dense["logits"][0]
    tol0 = rel * float(want.float().abs().max())
    e = max_err(got, want)
    print(f"  lane 0 (zero row, w = 1) against the dense serve of the base: "
          f"max|err| {e:.4e} (tolerance {tol0:.4e}); tokens "
          + ("equal" if torch.equal(rec["tokens"][0], dense["tokens"][0])
             else "differ"))
    check(e <= tol0, f"{arch}: lane 0 disagrees with the dense serve")
    return launches


def lanes_phase(dev, head=print) -> dict:
    """Phase 17: each family's personalized lanes at reduced size against
    the CPU, then at full width (``LANES_FULL``).  Returns each full-width
    run's launches."""
    card = card_line()
    t0 = time.perf_counter()
    for arch in LANES_FULL:
        head(f"[17] personalized lanes: reduced {arch}, 3 lanes, card "
             "against CPU, f32")
        lanes_parity(dev, arch)
    paths = {}
    for arch, (layers, n, seq, f32) in LANES_FULL.items():
        head(f"[17] personalized lanes: {arch} at full width, {n} lane(s), "
             f"{'f32' if f32 else 'bf16'}; card: {card}")
        paths[f"{arch} lanes path"] = lanes_serving(dev, arch, layers, n,
                                                    seq, f32)
        release()
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return paths


# -- phase 18: the two-tier family and the row-sharded bank --------------------

# Phase 5's clients in 4 pods of 25; every client draws k_out = 10
# cross-pod senders.
TWO_TIER_PODS = 4
SHARD_ROUNDS = 2


def panel_bound(m: int, n: int, d: int, es: int) -> tuple:
    """The row panel's bound: P, X and Y moved once; 2 m n D FLOP at the
    f32 peak."""
    return dense_mix_cost(m, n, d, es).bound_ms()


def halo_lists(idx, wgt, m: int):
    """Receivers 0..m-1 of ``(idx, wgt)`` as one shard of m rows sees them:
    the remote rows they read (nonzero weight, sorted) and each slot's row
    in ``[own rows; those rows]`` (a zero-weight remote slot points at
    halo row 0), as ``gossip_gather_halo`` remaps them."""
    own_idx, own_wgt = idx[:m].long(), wgt[:m]
    remote = (own_idx >= m) & (own_wgt != 0)
    rows = torch.unique(own_idx[remote])
    where = torch.zeros(idx.shape[0], dtype=torch.long, device=idx.device)
    where[rows] = torch.arange(rows.numel(), device=idx.device)
    slots = torch.where(own_idx < m, own_idx, m + where[own_idx])
    return rows, slots.to(torch.int32).contiguous()


def sharding_kernel_phase(dev, n: int = N_CLIENTS, d: int = CIFAR_CNN_DIM,
                          n_pods: int = TWO_TIER_PODS,
                          iters: int = 10) -> None:
    """Phase 18's kernel checks, outside any counted path: the dense mix's
    row panel (a shard's m = n / n_pods rows of the two-tier operator over
    the gathered bank) at (25, 100) x (100, D) and at the panel's edge
    shapes, f32 and bf16, own bank and one row in, against its plain
    version (phase 3's tolerance) and against the square launch's rows (bit
    for bit); the gather at the two-tier inter list (100, 11) bit for bit;
    the gather for a shard's 25 receivers over the gathered bank and over
    ``[own rows; halo rows]`` with the slots remapped, both bit for bit
    against the plain version and the square launch's rows.  Then each
    one's time beside its bound, its plain version's and a library call's
    (``torch.matmul``, TF32 off; the ``einsum`` over ``X[idx]``)."""
    from repro_torch.core import topology
    from repro_torch.kernels import gossip_gather as gg
    from repro_torch.kernels import gossip_matmul as gm

    gen = torch.Generator(device=dev).manual_seed(18)
    m = n // n_pods
    op = topology.sample_two_tier(gen, n, n_pods, 10)
    P = topology.dense_from_two_tier(op)
    for (m_, n_, d_) in [(m, n, d), (1, 9, 4097), (7, 100, 4098),
                         (64, 128, 4099), (3, 129, 4097), (100, 130, 3)]:
        Pm = (P[:m_, :n_] if n_ <= n else torch.rand(
            m_, n_, generator=gen, device=dev)).contiguous()
        cells = []
        for dt in (torch.float32, torch.bfloat16):
            for X in mix_banks(gen, n_, d_, dt, dev):
                got = gm.gossip_matmul(Pm, X)
                want = gm.gossip_matmul_plain(Pm, X)
                sync(dev)
                e = max_err(got, want)
                tol = (1e-6 if dt == torch.float32 else 2.0 ** -7) * float(
                    want.float().abs().max())
                check(e <= tol, f"row panel disagrees ({m_}, {n_}, {d_}, {dt})")
                Pn = torch.zeros(n_, n_, device=dev)
                Pn[:m_] = Pm
                same = torch.equal(got, gm.gossip_matmul(Pn, X)[:m_])
                # The kernels sum in one order whatever the rows; the CPU's
                # plain products need not.
                check(same or dev.type != "cuda",
                      f"row panel and square launch differ "
                      f"({m_}, {n_}, {d_}, {dt})")
                cells.append(f"{str(dt)[6:]} {e / tol if tol else e:.3f} "
                             f"(square rows equal: {same})")
                del got, want, X
        print(f"  row panel ({m_}, {n_}) x ({n_}, {d_}): max|err| / tolerance"
              f" (1e-6 max|Y| in f32, 2^-7 in bf16; own bank, one row in) "
              + ", ".join(cells))
    X = torch.randn(n, d, generator=gen, device=dev)
    Pm = P[:m].contiguous()
    b, by = panel_bound(m, n, d, 4)
    r = dict(ms=timed_ms(lambda: gm.gossip_matmul(Pm, X), dev, iters),
             plain=timed_ms(lambda: gm.gossip_matmul_plain(Pm, X), dev, iters),
             lib=timed_ms(lambda: torch.matmul(Pm, X), dev, iters))
    print(f"  row panel ({m}, {n}) x ({n}, {d}) f32: {r['ms']:.4f} ms, bound "
          f"{b:.4f} ms ({by}), {100 * b / r['ms']:.1f}% of it; plain "
          f"{r['plain']:.4f} ms; torch.matmul {r['lib']:.4f} ms")

    nl = op.inter
    k = nl.idx.shape[1]
    rows, slots = halo_lists(nl.idx, nl.wgt, m)
    for dt in (torch.float32, torch.bfloat16):
        Xd = X.to(dt)
        whole = gg.gossip_gather(nl.idx, nl.wgt, Xd)
        e = max_err(whole, gg.gossip_gather_plain(nl.idx, nl.wgt, Xd))
        check(e == 0.0, f"two-tier inter gather disagrees ({dt})")
        recv = gg.gossip_gather(nl.idx[:m].contiguous(),
                                nl.wgt[:m].contiguous(), Xd)
        e_recv = max_err(recv, gg.gossip_gather_plain(nl.idx[:m], nl.wgt[:m],
                                                      Xd))
        ext = torch.cat([Xd[:m], Xd[rows]])
        halo = gg.gossip_gather(slots, nl.wgt[:m].contiguous(), ext)
        e_halo = max_err(halo, gg.gossip_gather_plain(slots, nl.wgt[:m], ext))
        same = torch.equal(recv, whole[:m]) and torch.equal(halo, whole[:m])
        sync(dev)
        print(f"  gossip_gather two-tier inter ({n}, {k}) {str(dt)[6:]} "
              f"({gather_path(dev, n, k, dt)}): max|err| {e:.1e}; {m} "
              f"receivers over the gathered bank {e_recv:.1e}, over [{m} own; "
              f"{rows.numel()} halo] rows {e_halo:.1e} (tolerance 0); both "
              f"equal the whole mix's rows: {same}")
        check(e_recv == 0.0 and e_halo == 0.0 and same,
              f"the gather for a shard's receivers disagrees ({dt})")
        del Xd, whole, recv, ext, halo
    ext = torch.cat([X[:m], X[rows]])
    wm = nl.wgt[:m].contiguous()
    im = nl.idx[:m].contiguous()
    cases = {
        f"two-tier inter ({n}, {k})": (
            lambda: gg.gossip_gather(nl.idx, nl.wgt, X),
            lambda: gg.gossip_gather_plain(nl.idx, nl.wgt, X),
            lambda: torch.einsum("nk,nkd->nd", nl.wgt, X[nl.idx.long()]),
            gather_cost(n, n, k, d, 4)),
        f"{m} receivers over the gathered ({n}, D)": (
            lambda: gg.gossip_gather(im, wm, X),
            lambda: gg.gossip_gather_plain(im, wm, X),
            lambda: torch.einsum("nk,nkd->nd", wm, X[im.long()]),
            gather_cost(m, n, k, d, 4)),
        f"{m} receivers over [{m} own; {rows.numel()} halo]": (
            lambda: gg.gossip_gather(slots, wm, ext),
            lambda: gg.gossip_gather_plain(slots, wm, ext),
            lambda: torch.einsum("nk,nkd->nd", wm, ext[slots.long()]),
            gather_cost(m, ext.shape[0], k, d, 4)),
    }
    for what, (kern, plain, lib, cost) in cases.items():
        b, by = cost.bound_ms()
        t = timed_ms(kern, dev, iters)
        print(f"  gossip_gather {what} f32: {t:.4f} ms, bound {b:.4f} ms "
              f"({by}), {100 * b / t:.1f}% of it; plain "
              f"{timed_ms(plain, dev, iters):.4f} ms; einsum "
              f"{timed_ms(lib, dev, iters):.4f} ms")
    intra = timed_ms(lambda: torch.bmm(op.intra, X.view(n_pods, m, d)), dev,
                     iters)
    print(f"  the intra-pod term (torch.bmm, ({n_pods}, {m}, {m}) x "
          f"({n_pods}, {m}, {d}), TF32 off): {intra:.4f} ms")
    del X, ext


def state_copy(st):
    """A copy of a round state's tensors (generators shared)."""
    def cp(x):
        return x.clone() if isinstance(x, torch.Tensor) else x
    return st._replace(params=cp(st.params), mom=cp(st.mom), w=cp(st.w),
                       losses=cp(st.losses))


def timed_round(dev, trainer, draws) -> tuple:
    """One round on ``draws``: its loss, wall seconds and launches (the
    kernels launched at all)."""
    before = read_counts()
    sync(dev)
    t = time.perf_counter()
    metrics = trainer.run_round(draws)
    loss = float(metrics["loss"])
    sync(dev)
    wall = time.perf_counter() - t
    used = {k: v - before[k] for k, v in read_counts().items()}
    return loss, wall, {k: v for k, v in used.items() if v}


def two_tier_path(dev, data, n_clients: int = N_CLIENTS,
                  n_pods: int = TWO_TIER_PODS, rounds: int = 3,
                  local_steps: int = 5) -> dict:
    """Phase 5's DFedSGPSM on cifar_cnn over the two-tier family: each round
    one draw (the operator and the minibatches) taken by the dense form
    (``gossip="dense"``: ``gossip_matmul.cu``) and by the operator form
    (``gossip="sparse"``: the intra ``bmm`` plus ``gossip_gather.cu`` on the
    inter list), both from the dense trainer's state; the banks within
    1e-5 of their magnitude (f32 sums in their own orders; the local steps
    equal, ``cudnn.deterministic`` being set for the phase), the mass 100
    within 1e-3.  Returns the launches of the 2 x ``rounds`` rounds."""
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo, topology
    from repro_torch.models.small import cifar_cnn

    cdata, test = data
    model = cifar_cnn()
    algo = make_algo("dfedsgpsm", local_steps=local_steps, batch_size=32,
                     lr=0.01)
    topo = TopologyConfig(kind="two_tier", n_clients=n_clients, k_out=10,
                          n_pods=n_pods)
    tr = {g: FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                       gossip=g, device=dev) for g in ("dense", "sparse")}
    check(not tr["dense"].program.sparse_mix and tr["sparse"].program.sparse_mix,
          "the two forms' operators")
    gen = torch.Generator(device=dev).manual_seed(5)
    m_rows = cdata["x"].shape[1]
    zero_counts()  # the path's counts start here
    for r in range(rounds):
        op = topology.sample_two_tier(gen, n_clients, n_pods, 10)
        idx = torch.randint(0, m_rows, (local_steps, n_clients, 32),
                            generator=gen, device=dev)
        tr["sparse"].state = state_copy(tr["dense"].state)
        for g, P, mix in (("dense", topology.dense_from_two_tier(op),
                           "gossip_matmul"), ("sparse", op, "gossip_gather")):
            loss, wall, used = timed_round(dev, tr[g], {"P": P,
                                                        "batch_idx": idx})
            mass = float(tr[g].state.w.sum())
            print(f"  two-tier {'dense' if g == 'dense' else 'operator'} "
                  f"round {r}: loss {loss:.4f} mass {mass:.6f} wall "
                  f"{wall:.3f} s launches {used}")
            check(math.isfinite(loss), f"two-tier {g} round {r}: loss {loss}")
            check(abs(mass - n_clients) <= 1e-3,
                  f"two-tier {g} round {r}: push-sum mass {mass}")
            check(used == {"fused_update_bank": local_steps, mix: 1},
                  f"two-tier {g} round {r}: launches {used}")
        a, b = tr["dense"].state, tr["sparse"].state
        e = max_err(a.params, b.params)
        tol = 1e-5 * float(a.params.abs().max())
        dw = max_err(a.w, b.w)
        print(f"    dense against operator form: bank max|err| {e:.3e} "
              f"({e / tol:.4f} of 1e-5 max|x|), w {dw:.3e} (1e-6)")
        check(e <= tol and dw <= 1e-6, f"two-tier forms disagree, round {r}")
    launches = read_counts()
    tl, ta = tr["sparse"].evaluate(test)
    print(f"  operator form: test loss {tl:.4f} acc {ta:.4f}")
    check(math.isfinite(tl), f"two-tier test loss {tl}")
    return launches


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def executor_name(backend, shard) -> str:
    if backend is None or isinstance(backend, str):
        return ("all-gather (all_gather of the bank, then the gather over the "
                f"rank's {shard.m} receivers)")
    if backend.plan.n_shards == 1:
        return "halo; one shard, so its all-gather form, as the reference's"
    return f"halo ({'static' if backend.plan.static else 'dynamic'} plan)"


def sharded_path(dev, data, n_clients: int = N_CLIENTS,
                 n_pods: int = TWO_TIER_PODS, rounds: int = SHARD_ROUNDS,
                 local_steps: int = 5) -> dict:
    """The sharded program through ``FLTrainer(mesh=)`` on a one-rank clients
    mesh (NCCL on the card, gloo on the CPU), ``gossip="xla"`` and
    ``"halo"``, kout k_out = 10 and two_tier, ``rounds`` rounds each, held
    to the unsharded program on the same draws from the same state (bank
    within 1e-5 of its magnitude, w within 1e-6); the executor each ran,
    and the round times.  The
    process group starts here and is torn down at the end.  Returns the
    launches of the sharded rounds."""
    from repro_torch.core import FLTrainer, TopologyConfig, make_algo, topology
    from repro_torch.launch.mesh import close_clients_world, init_clients_world
    from repro_torch.models.small import cifar_cnn

    cdata, _ = data
    model = cifar_cnn()
    algo = make_algo("dfedsgpsm", local_steps=local_steps, batch_size=32,
                     lr=0.01)
    m_rows = cdata["x"].shape[1]
    mesh = init_clients_world(0, 1, free_port(), device=dev)
    launches = {k: 0 for k in counters()}
    try:
        import torch.distributed as dist

        print(f"  process group: {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {mesh}")
        for topo in (TopologyConfig(kind="kout", n_clients=n_clients, k_out=10),
                     TopologyConfig(kind="two_tier", n_clients=n_clients,
                                    k_out=10, n_pods=n_pods)):
            gen = torch.Generator(device=dev).manual_seed(7)
            draws = []
            for _ in range(rounds):
                P = topology.sample_neighbors(gen, topo)
                idx = torch.randint(0, m_rows, (local_steps, n_clients, 32),
                                    generator=gen, device=dev)
                draws.append({"P": P, "batch_idx": idx})
            ref = FLTrainer(model.loss, model.init, cdata, algo, topo, seed=0,
                            gossip="sparse", device=dev)
            want, walls = [], []
            for d in draws:
                _, wall, _ = timed_round(dev, ref, d)
                want.append((ref.state.params.clone(), ref.state.w.clone()))
                walls.append(wall)
            print(f"  {topo.kind} unsharded rounds: wall "
                  + ", ".join(f"{w:.3f}" for w in walls) + " s")
            del ref
            for gossip in ("xla", "halo"):
                tr = FLTrainer(model.loss, model.init, cdata, algo, topo,
                               seed=0, gossip=gossip, mesh=mesh, device=dev)
                shard = tr.program.shard
                print(f"  {topo.kind} gossip={gossip!r}: executor "
                      + executor_name(tr.program.mixer.backend, shard))
                zero_counts()
                for r, d in enumerate(draws):
                    loss, wall, used = timed_round(dev, tr, d)
                    whole = tr.program.whole_state(tr.state)
                    e = max_err(whole.params, want[r][0])
                    tol = 1e-5 * float(want[r][0].abs().max())
                    dw = max_err(whole.w, want[r][1])
                    mass = float(whole.w.sum())
                    print(f"    round {r}: loss {loss:.4f} mass {mass:.6f} "
                          f"wall {wall:.3f} s; against unsharded: bank "
                          f"max|err| {e:.3e} ({e / tol:.4f} of 1e-5 max|x|; "
                          f"bit for bit: {e == 0.0}), w {dw:.3e}; launches "
                          f"{used}")
                    check(math.isfinite(loss) and abs(mass - n_clients) <= 1e-3,
                          f"sharded {topo.kind} {gossip} round {r}: loss "
                          f"{loss}, mass {mass}")
                    check(e <= tol and dw <= 1e-6,
                          f"sharded {topo.kind} {gossip} round {r} disagrees")
                    check(used == {"fused_update_bank": local_steps,
                                   "gossip_gather": 1},
                          f"sharded {topo.kind} {gossip} round {r}: launches "
                          f"{used}")
                for k, v in read_counts().items():
                    launches[k] += v
                del tr, whole
    finally:
        close_clients_world()
    check(launches["gossip_gather"] > 0, "the sharded path launched no gather")
    return launches


def sharding_phase(dev, data=None, head=print) -> dict:
    """Phase 18 whole (``head`` prints each step's heading): the kernel
    checks, the two-tier rounds and the sharded program at phase 5's size,
    with ``cudnn.deterministic`` set (its rounds are held to each other
    from equal states, so their local steps must be equal: cuDNN's default
    convolution gradients sum in no fixed order).  Returns the launches of
    its two main paths.  ``python3 repeat_phase.py --repeat 1
    sharding_phase`` runs it alone."""
    card = card_line() if dev.type == "cuda" else "no card"
    head(f"[18] the two-tier family and the row-sharded bank: the row panel "
         f"and the gather for a shard's receivers; card: {card}")
    sharding_kernel_phase(dev)
    release()
    data = data or cifar_data(dev)
    paths = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        head(f"[18] two-tier rounds: cifar_cnn, {N_CLIENTS} clients in "
             f"{TWO_TIER_PODS} pods, k_out=10, dense and operator form")
        paths["two-tier path"] = two_tier_path(dev, data)
        release()
        head(f"[18] the sharded program on a one-rank clients mesh: kout and "
             f"two_tier, gossip 'xla' and 'halo', {SHARD_ROUNDS} rounds each")
        paths["sharded path"] = sharded_path(dev, data)
        release()
    finally:
        torch.backends.cudnn.deterministic = prev
    return paths


# -- phase 19: the dry-run against the card -----------------------------------

# The whole steps the card checks, each traced on meta by the dry-run's
# ``trace`` at the configuration the card then runs: glm4-9b at full width
# cut to 4 of its 40 layers (as phase 12) and hubert-xlarge whole.
DRYRUN_RECORDS = (
    # (arch, layers or None for all, (shape name, S, B, kind), step)
    ("glm4-9b", TRAIN_LAYERS, ("prefill_2x4096", 4096, 2, "prefill"),
     "forward"),
    ("glm4-9b", TRAIN_LAYERS, ("decode_2x4096", 4096, 2, "decode"),
     "serve_step"),
    ("glm4-9b", TRAIN_LAYERS, ("train_1x4096", 4096, 1, "train"),
     "train_step"),
    ("glm4-9b", TRAIN_LAYERS, ("train_2x4096", 4096, 2, "train"),
     "round_step"),
    ("hubert-xlarge", None, ("prefill_8x1500", 1500, 8, "prefill"),
     "forward"),
)
# The production mesh's rank-0 steps the card runs as rank 0 of a fake world
# of 256 ranks (``launch.mesh.fake_world``), each traced on meta by the
# dry-run's ``run_one`` on "single": glm4-9b at full width cut to 4 layers,
# 16 x 4096 tokens (a local batch of 1 x 4096, 2 of its 32 query heads,
# both kv heads gathered whole; train_4k's 16 x 4096 a rank does not fit:
# the loss gathers the whole vocabulary's logits, 40 GB a copy in f32), and
# xlstm-350m's first group of 6 layers (5 mLSTM, each rank a quarter of a
# head; 1 sLSTM, every head on every rank) at 256 x 64 tokens (16 x 64 a
# rank: the sLSTM's time loop, one position at a time, sets its length).
# Then two decode steps on a placed cache: glm4-9b at 4 layers, decode_32k's
# 128 requests on a 32,768-position cache (8 rows a rank, head_dim on
# "model"), and gemma3-12b at one 5:1 period of 6 layers, long_500k's one
# request on 524,288 positions (32,768 a rank on "data", head_dim on
# "model"; the step writes on the last rank's block).
PLACED_RECORDS = (
    # (arch, layers, (shape name, S, B, kind), timed)
    ("glm4-9b", TRAIN_LAYERS, ("train_16x4096", 4096, 16, "train"), True),
    ("xlstm-350m", 6, ("train_256x64", 64, 256, "train"), False),
    ("glm4-9b", TRAIN_LAYERS, ("decode_32k", 32768, 128, "decode"), True),
    ("gemma3-12b", 6, ("long_500k", 524288, 1, "decode"), True),
)
# A roofline time longer than the measured one overstates the work.
SHARE_LIMIT = 1.05
PEAK_TOLERANCE = 0.25  # predicted peak within 25% of the measured one
DRYRUN_RUNS = 3
# The kernels whose records a counted run holds to the launch counters.
RECORDED = ("flash_attention", "flash_attention_backward", "gossip_matmul",
            "gossip_gather", "fused_update_bank")


def counted_run(dev, what: str, meta: dict, args, run, base: int,
                runs: int = DRYRUN_RUNS) -> None:
    """One step (``run(*args)``) on the card against its meta trace
    ``meta``: (a) the counting mode around the card's run counts the
    trace's FLOPs, bytes and collectives, and as many kernel records as the
    wrappers' launch counters moved; (b) with ``runs``, the roofline time
    max(t_compute, t_memory) of the trace over the step's median time (CUDA
    events around each of ``runs`` runs after a warm-up) is at most
    ``SHARE_LIMIT``; (c) the predicted peak (arguments + the trace's
    high-water mark) is within ``PEAK_TOLERANCE`` of
    ``torch.cuda.max_memory_allocated()`` less ``base`` over one run from a
    reset with the arguments resident."""
    from repro_torch.roofline.cost import CostMode

    t_roof = max(meta["flops"] / BF16_FLOP_PER_S,
                 meta["bytes accessed"] / HBM_BYTES_PER_S)
    sync(dev)
    before = read_counts()
    with CostMode(args) as mode:
        run(*args)
    sync(dev)
    moved = {k: v - before[k] for k, v in read_counts().items()}
    got = mode.result()
    print(f"  {what}: counted on the card: {got['aten_ops']} aten ops, "
          f"{got['flops']:.6g} FLOP, {got['bytes accessed']:.6g} bytes, "
          f"kernel records { {k: v['launches'] for k, v in got['kernels'].items()} }"
          f", launches {moved}, collectives {got['collectives']}")
    check(got["flops"] == meta["flops"]
          and got["bytes accessed"] == meta["bytes accessed"],
          f"{what}: the card's run counts other FLOPs or bytes than the meta "
          f"trace")
    check(got["collectives"] == meta["collectives"],
          f"{what}: the card's run makes other collectives than the meta "
          f"trace: {got['collectives']} against {meta['collectives']}")
    for name in RECORDED:
        n_rec = got["kernels"].get(name, {}).get("launches", 0)
        n_meta = meta["kernels"].get(name, {}).get("launches", 0)
        check(n_rec == moved[name] == n_meta,
              f"{what}: {n_rec} {name} records on the card, {n_meta} on "
              f"meta, {moved[name]} launches")
    if runs:
        run(*args)  # warm-up
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        share = 1e3 * t_roof / ms
        print(f"  {what}: measured {', '.join(f'{t:.3f}' for t in times)} "
              f"ms, median {ms:.3f} ms")
        print(f"  {what}: roofline share {share:.4f} (roofline "
              f"{1e3 * t_roof:.4f} ms over the median; at most "
              f"{SHARE_LIMIT})")
        check(share <= SHARE_LIMIT,
              f"{what}: the roofline time is {share:.3f} of the measured "
              f"time: the count overstates the work")
    torch.cuda.reset_peak_memory_stats(dev)
    run(*args)
    sync(dev)
    measured = torch.cuda.max_memory_allocated(dev) - base
    ratio = meta["memory"]["peak_estimate"] / measured
    print(f"  {what}: peak ratio {ratio:.4f} (predicted "
          f"{meta['memory']['peak_estimate'] / 2 ** 30:.3f} GiB = arguments "
          f"{meta['memory']['argument'] / 2 ** 30:.3f} + temporaries "
          f"{meta['memory']['temp'] / 2 ** 30:.3f}; measured "
          f"{measured / 2 ** 30:.3f} GiB; within {PEAK_TOLERANCE:.0%})")
    check(abs(ratio - 1) <= PEAK_TOLERANCE,
          f"{what}: predicted peak {ratio:.3f} of the measured one")


def trimmed_api(arch: str, layers):
    """``arch``'s model at full width, cut to ``layers`` layers (all with
    None)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model_api

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return get_model_api(cfg)


def dryrun_record(dev, arch: str, layers, shape, step: str,
                  runs: int = DRYRUN_RUNS) -> None:
    """One whole step against the card: its meta trace (``dryrun.trace``,
    the ``card`` record's), then the same step on the card with drawn
    values (``dryrun.step_args``), through :func:`counted_run`."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun

    shape = InputShape(*shape)
    api = trimmed_api(arch, layers)
    meta = dryrun.trace(api, shape, step)
    what = f"{arch} {shape.name} (the whole {step})"
    t_roof = max(meta["flops"] / BF16_FLOP_PER_S,
                 meta["bytes accessed"] / HBM_BYTES_PER_S)
    print(f"  {what}: traced on meta in {meta['compile_s']} s, "
          f"{meta['aten_ops']} aten ops, {meta['flops']:.6g} FLOP, "
          f"{meta['bytes accessed']:.6g} bytes, kernels "
          f"{ {k: v['launches'] for k, v in meta['kernels'].items()} }, "
          f"roofline {1e3 * t_roof:.4f} ms, predicted peak "
          f"{meta['memory']['peak_estimate'] / 2 ** 30:.3f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    args, run = dryrun.step_args(api, shape, step, device=dev, seed=0)
    counted_run(dev, what, meta, args, run, base, runs)
    del args, run


def placed_record(dev, arch: str, layers, shape, timed: bool) -> float:
    """One production-mesh record against the card: ``dryrun.run_one`` on
    "single" traces rank 0's own step on meta, as rank 0 of a fake world
    of 256 ranks; then the card runs the same step as rank 0 of a fake world
    of 256 ranks on CUDA (``launch.mesh.fake_world``, whose collectives move
    nothing and leave their outputs as allocated), its arguments drawn
    from seed 0 and placed by the runtime's code
    (``dryrun.placed_step_args``), through :func:`counted_run`
    (with ``timed`` the time and its share of the roofline, communication
    excluded).  A fake world that fails to start fails the phase.  Returns
    the seconds it took."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    t0 = time.perf_counter()
    shape = InputShape(*shape)
    traces = {}
    rec = dryrun.run_one(arch, shape, "single",
                         overrides={"n_layers": layers}, traces=traces)
    check(rec["status"] == "ok" and rec["per_device"] == "rank 0",
          f"the rank-0 record of {arch} {shape.name} failed: "
          f"{rec.get('error')}")
    meta = traces[(arch, shape, rec["step"], "single")]
    terms = rec["roofline"]
    what = (f"{arch} {shape.name} at {layers} layers, rank 0 of 256 "
            f"({rec['step']}, communication excluded)")
    print(f"  {what}: traced on meta in {meta['compile_s']} s, "
          f"{meta['aten_ops']} aten ops, {meta['flops']:.6g} FLOP, "
          f"{meta['bytes accessed']:.6g} bytes, kernels "
          f"{ {k: v['launches'] for k, v in meta['kernels'].items()} }, "
          f"collectives {meta['collectives']}, roofline "
          f"{1e3 * max(terms['t_compute_s'], terms['t_memory_s']):.4f} ms "
          f"({terms['bottleneck']} with the collectives), "
          f"predicted peak {meta['memory']['peak_estimate'] / 2 ** 30:.3f} "
          f"GiB")
    api = trimmed_api(arch, layers)
    mesh = make_production_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    with fake_world(tuple(mesh.shape[a] for a in mesh.axis_names),
                    mesh.axis_names, dev) as dmesh:
        args, run = dryrun.placed_step_args(api, shape, rec["step"], dmesh,
                                            device=dev, seed=0)
        counted_run(dev, what, meta, args, run, base,
                    DRYRUN_RUNS if timed else 0)
        del args, run
    return time.perf_counter() - t0


def table_rows(dev, iters: int = 10) -> None:
    """Numbers of ``PERF.md``'s kernel table that earlier runs left out:
    SDPA beside the flash forward at glm4-9b's training shape, and
    ``torch.matmul`` beside the dense mix at hymba-1.5b's 4-layer pod
    bank (2 replicas, f32), each with its bound."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_matmul as gm
    from repro_torch.launch.steps import pod_mixing_matrix
    from repro_torch.models.pdefs import tree_num_params
    from repro_torch.models.registry import get_model_api

    gen = torch.Generator(device=dev).manual_seed(19)
    b, h, kv, s, hd = TRAIN_SHAPE
    q, k, v = (torch.randn(b, n, s, hd, generator=gen, device=dev).to(
        torch.bfloat16) for n in (h, kv, kv))
    bound, by = flash_forward_cost(b, h, kv, s, hd, True, 0, 2, lse=True
                                   ).bound_ms(BF16_FLOP_PER_S)
    ms = timed_ms(lambda: fa.flash_attention_with_lse(q, k, v, True, 0), dev,
                  iters)
    lib = timed_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), dev, iters)
    print(f"  flash forward with the row logsumexp at glm4-9b's training "
          f"shape {TRAIN_SHAPE}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"{100 * bound / ms:.1f}% of it; SDPA {lib:.4f} ms; kernel/SDPA "
          f"{ms / lib:.3f}")
    del q, k, v
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=4)
    d = tree_num_params(get_model_api(cfg).param_defs())
    X = torch.randn(2, d, generator=gen, device=dev)
    P = pod_mixing_matrix(2, device=dev)
    bound, by = dense_mix_cost(2, 2, d, 4).bound_ms()
    ms = timed_ms(lambda: gm.gossip_matmul(P, X), dev, iters)
    lib = timed_ms(lambda: torch.matmul(P, X), dev, iters)
    print(f"  gossip_matmul at hymba-1.5b's 4-layer pod bank (2, {d}) f32: "
          f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% "
          f"of it; torch.matmul (TF32 off) {lib:.4f} ms")
    del X


def dryrun_phase(dev, head=print) -> dict:
    """Phase 19 whole (``head`` prints each step's heading): each whole
    step of ``DRYRUN_RECORDS`` against the card (:func:`dryrun_record`),
    each rank-0 step of ``PLACED_RECORDS`` (:func:`placed_record`), then
    the kernel table's missing numbers (:func:`table_rows`).  Returns the
    launches of its path.  ``python3 repeat_phase.py --repeat 1
    dryrun_phase`` runs it alone."""
    from repro_torch.launch.mesh import card_hardware

    card = card_line() if dev.type == "cuda" else "no card"
    head(f"[19] the dry-run against the card: {len(DRYRUN_RECORDS)} records "
         f"traced on meta, then run; card: {card}")
    hbm = card_hardware()["hbm_bytes"] if dev.type == "cuda" else None
    print(f"  the card's memory (torch.cuda.get_device_properties): "
          + ("none" if hbm is None else f"{hbm / 2 ** 30:.2f} GiB, "
             f"{hbm} bytes; the data sheet's {HARDWARE['hbm_bytes']}"))
    zero_counts()
    for arch, layers, shape, step in DRYRUN_RECORDS:
        dryrun_record(dev, arch, layers, shape, step)
        release()
    head(f"[19] the production mesh's rank-0 steps: "
         f"{len(PLACED_RECORDS)} records traced on meta, then run as rank 0 "
         f"of a fake world of 256 ranks; card: {card}")
    for arch, layers, shape, timed in PLACED_RECORDS:
        secs = placed_record(dev, arch, layers, shape, timed)
        print(f"  {arch} took {secs:.1f} s")
        release()
    paths = {"dry-run path": read_counts()}
    head("[19] the kernel table's missing numbers")
    table_rows(dev)
    release()
    return paths


# -- phase 20: gemma3-12b's pod round, the flash backward at hd 256 -----------

# gemma3-12b cut to one 5:1 period of its 48 layers (layers 0-4 local,
# window 1024; layer 5 global), 1 x 4096 tokens a pod a step.
GEMMA_TRAIN = (6, 1, 4096)


def gemma_phase(dev, head=print) -> dict:
    """Phase 20 whole (``head`` prints each step's heading): reduced
    gemma3-12b's pod round, card against CPU (f32, hd 64, windowed and
    global layers), then gemma3-12b at full width cut to one 5:1 period
    through :func:`pod_training` (48 flash backward calls a round, every one
    on the hd 256 tensor-core passes).  Returns the launches of its main
    path.  ``python3 repeat_phase.py --repeat 1 gemma_phase`` runs it
    alone."""
    card = card_line() if dev.type == "cuda" else "no card"
    head("[20] training: reduced gemma3-12b, 2 pods, card against CPU, f32")
    train_parity(dev, seq=64, arch="gemma3-12b")
    layers, batch_n, seq = GEMMA_TRAIN
    head(f"[20] training: gemma3-12b at full width cut to {layers} layers, "
         f"2 pods, K = 2, {batch_n} x {seq} tokens, {TASK_ROUNDS} rounds; "
         f"card: {card}")
    paths = {"gemma3-12b training path": pod_training(
        dev, "gemma3-12b", layers, batch_n, seq, GEMMA_TRAIN_SHAPE,
        TASK_ROUNDS)}
    release()
    return paths

# -- phase 21: the pod runtime on a one-rank NCCL world -----------------------

# The pod runtime's mesh on one card: (shape, axis names).
POD_MESH = ((1, 1, 1), ("pod", "data", "model"))
POD_ROUNDS = 2
# Each executor with its pod graph: "xla" over the dense ring (the dense
# mix), "halo" over its neighbor list (the gather).
POD_RUNS = (("xla", "dense"), ("halo", "neighbors"))
# The kernels of the path, counted per round on both sides.
POD_KERNELS = ("flash_attention", "flash_attention_backward",
               "flash_attention_backward_kernels", "gossip_matmul",
               "gossip_gather", "fused_update_bank")


def kernel_symbols(prof) -> dict:
    """{kernel symbol: launches} of the flash and mix kernels in a profile
    (the name up to its argument list, without its return type and
    anonymous namespaces)."""
    import re

    out = {}
    for e in prof.key_averages():
        if re.search(r"flash|gather_(panels|rows)|mix_(resident|tiled)",
                     e.key):
            key = e.key.replace("(anonymous namespace)::", "")
            key = key.removeprefix("void ").split("(")[0]
            out[key] = out.get(key, 0) + e.count
    return out


PROFILE_PAD_S = 0.05  # idle seconds inside each end of a profile
# Profiled runs a side (rounds, prefills), until one holds every launch.
PROFILE_TRIES = 3


@contextlib.contextmanager
def device_profile(dev):
    """``torch.profiler`` over the device's events (the CPU's off a card),
    the work inside it kept :data:`PROFILE_PAD_S` of idle device time away
    from both ends of the profile's window: late in the script profiles
    missed kernels at their ends (a round's last kernel, a prefill's first
    flash launch), which the profiler keeps only inside its window on the
    host's clock."""
    kinds = ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
             else None)
    with torch.profiler.profile(activities=kinds) as prof:
        sync(dev)
        time.sleep(PROFILE_PAD_S)
        yield prof
        sync(dev)
        time.sleep(PROFILE_PAD_S)


# The wrappers' counts of the kernels :func:`kernel_symbols` names.
PROFILED = ("flash_attention", "flash_attention_backward_kernels",
            "gossip_matmul", "gossip_gather")


def profiled(pair: tuple) -> str:
    """A (:func:`kernel_symbols`, complete) pair as printed."""
    return f"{pair[0]}" + ("" if pair[1] else " (the profile missed events)")


def check_same_kernels(what: str, got: tuple, base: tuple) -> None:
    """Hold two runs' kernels by symbol, each a (:func:`kernel_symbols`,
    complete) pair: complete where the profile holds every launch the
    wrappers counted in it.  Two complete profiles must name the same
    kernels the same number of times; otherwise the same kernels.  Late in
    the script the profiler has dropped kernels' events (1 of a round's 64
    flash launches, a round's only mix, 1 of a prefill's 2 flash
    launches); the wrappers' counts are exact and held apart."""
    (a, full_a), (b, full_b) = got, base
    if full_a and full_b:
        check(a == b, f"{what}: kernels {a} against the mesh-less {b}")
    else:
        check(set(a) == set(b), f"{what}: kernels {a} against the mesh-less "
              f"{b} (a profile missed events)")


def pod_round_run(dev, api, step_cfg, init, data, P, gossip: str, mesh,
                  rounds: int = POD_ROUNDS) -> dict:
    """``rounds`` rounds of ``make_round_step(gossip=...)`` from the whole
    pod-stacked ``init`` (copied) on ``data``, the task's batches (a dict
    of arrays of shape (rounds, pods, K, B, ...), :func:`round_batches`):
    mesh-less with ``mesh`` None (every pod stacked on the card), else
    under the pod runtime on ``mesh`` (the replicas placed by
    ``place_pods``: DTensors).  Per round the wall time
    and the launches of :data:`POD_KERNELS`; every round profiled (the
    device's events only) for the kernels' symbols, and ``symbols`` those
    of the last round whose profile holds all its launches, with
    ``complete`` saying whether one did.  Where no round's profile held
    them all, the state after the rounds is kept on the host and up to
    :data:`PROFILE_TRIES` - 1 more rounds on the last round's batch are
    profiled until one does (their state discarded, their launches counted
    nowhere).  Returns the state after the rounds gathered whole (params,
    w), the metrics and the peak memory."""
    import contextlib

    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    round_step = steps.make_round_step(api, step_cfg, gossip=gossip)
    n_pods = next(iter(data.values())).shape[1]
    with torch.no_grad():
        params = tree_map(torch.clone, init)
    w = torch.ones(n_pods, dtype=torch.float32, device=dev)
    if mesh is not None:
        rows = steps.pod_rows(mesh, n_pods)
        params = steps.place_pods(api, params, mesh)
        w = rows.rows(w)
        check(all(shlib.is_dtensor(x) for x in tree_flatten(params)[1]),
              "the pod runtime placed plain tensors")
    v = tree_map(torch.zeros_like, params)
    on_mesh = ((lambda: shlib.use_mesh(mesh, fsdp=api.cfg.fsdp))
               if mesh is not None else contextlib.nullcontext)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def profiled_round(r):
        """Round ``r``'s batch through one profiled round on the state:
        (symbols, launches, complete, wall, metrics)."""
        nonlocal params, v, w
        batch = {k: x[r] if mesh is None else rows.rows(x[r])
                 for k, x in data.items()}
        before = read_counts()
        with device_profile(dev) as prof:
            t = time.perf_counter()
            params, v, w, _, _, m = round_step(params, v, w, (), (), batch, P)
            sync(dev)
            wall = time.perf_counter() - t
        syms = kernel_symbols(prof)
        del prof
        now = read_counts()
        used = {k: now[k] - before[k] for k in POD_KERNELS}
        full = sum(syms.values()) == sum(used[k] for k in PROFILED)
        return syms, used, full, wall, (float(m["loss"]), float(m["acc"]))

    walls, used, metrics, symbols, complete = [], [], [], {}, False
    zero_counts()
    with on_mesh():
        for r in range(rounds):
            syms, u, full, wall, m = profiled_round(r)
            walls.append(wall)
            used.append(u)
            metrics.append(m)
            if full or not complete:
                symbols, complete = syms, full
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    out, out_w = params, w
    if mesh is not None:
        out = steps.gather_pods(params, mesh, n_pods)
        out_w = rows.all_gather(w)
    if not complete:  # the rounds' end kept: the extra rounds write in place
        out = tree_map(lambda x: x.to("cpu", copy=True), out)
        out_w = out_w.clone()
        with on_mesh():
            for _ in range(PROFILE_TRIES - 1):
                syms, _, complete, _, _ = profiled_round(rounds - 1)
                if complete:
                    symbols = syms
                    break
    del v
    return {"params": out, "w": out_w, "walls": walls, "used": used,
            "metrics": metrics, "symbols": symbols, "complete": complete,
            "peak": peak, "launches": launches}


def leaf_errors(got, want) -> dict:
    """{leaf path: max |got - want| / max |want|}, leaf by leaf on
    ``got``'s device (``want`` may wait on the host)."""
    from repro_torch.core.flat import tree_flatten

    paths, a = tree_flatten(got)
    _, b = tree_flatten(want)
    out = {}
    for path, x, y in zip(paths, a, b):
        y = y.to(x.device)
        scale = float(y.float().abs().max())
        err = float((x.float() - y.float()).abs().max())
        out["/".join(path)] = err / scale if scale else err
    return out


def pod_runtime_phase(dev, head=print, layers: int = TRAIN_LAYERS,
                      seq: int = 4096, cfg=None,
                      rounds: int = POD_ROUNDS) -> dict:
    """Phase 21 whole (``head`` prints each step's heading): the pod runtime
    (``launch.mesh.init_world`` of a ``(1, 1, 1)`` ``("pod", "data",
    "model")`` mesh over a one-rank NCCL world; ``launch.steps.place_pods``,
    ``make_round_step`` under ``launch.sharding.use_mesh``) on glm4-9b at
    full width cut to ``layers`` layers (bf16), 2 pods stacked on the rank
    as DTensors (the replicas [x, x / 2] of one draw from seed 0), K = 2,
    1 x ``seq`` tokens a pod a step from ``make_lm_stream``, lr 0.05,
    alpha 0.9, rho 0.05, ``rounds`` rounds under "xla" (the dense ring:
    the dense mix) and "halo" (its neighbor list: the gather; one pod-axis
    rank, so its all-gather form).  Each against the mesh-less round
    (phase 12's code: ``make_round_step`` on the stacked pods) on the same
    state and batches: params and w bit for bit, or each leaf within 1e-5
    of its magnitude with the leaves that differ named; the loss and
    accuracy; the launches of the flash forward, its backward (calls and
    kernels) and the mixes a round, and the kernels' symbols in a profiled
    round, equal.  Prints both sides' round wall times (the host cost of
    DTensor dispatch) and peak memory beside the card.  Closes its process
    group.  ``cfg`` replaces glm4-9b's config (a CPU rehearsal passes a
    reduced one; it runs gloo).  Returns the launches of the runtime's
    rounds."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_map
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import close_clients_world, init_world
    from repro_torch.models.registry import get_model_api

    card = card_line() if dev.type == "cuda" else "no card"
    cfg = dataclasses.replace(cfg or get_config("glm4-9b"), n_layers=layers)
    api = get_model_api(cfg)
    n_pods, k_steps = 2, 2
    step_cfg = steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05,
                                local_steps=k_steps)
    head(f"[21] the pod runtime on a one-rank NCCL world: {cfg.name} at "
         f"full width cut to {layers} layers, {n_pods} pods on a "
         f"{POD_MESH[0]} {POD_MESH[1]} mesh, K = {k_steps}, 1 x {seq} "
         f"tokens, {rounds} rounds a run; card: {card}")
    t0 = time.perf_counter()
    mesh = init_world(0, 1, free_port(), dev, *POD_MESH)
    paths = {}
    try:
        with torch.no_grad():
            p = api.init(torch.Generator(device=dev).manual_seed(0), dev)
            init = tree_map(lambda x: torch.stack([x, x * 0.5]), p)
            del p
        toks = make_lm_stream(cfg.vocab_size, seq,
                              rounds * n_pods * k_steps).reshape(
            rounds, n_pods, k_steps, 1, seq).to(dev)
        print(f"  world and mesh up, {api.num_params() / 1e9:.3f} B "
              f"parameters a replica in {str(cfg.dtype)[6:]} (fsdp "
              f"{cfg.fsdp}), state drawn: {time.perf_counter() - t0:.1f} s")
        total = None
        for gossip, form in POD_RUNS:
            P = (steps.pod_mixing_matrix(n_pods, dev) if form == "dense"
                 else steps.pod_mixing_neighbors(n_pods, dev))
            base = pod_round_run(dev, api, step_cfg, init, {"tokens": toks},
                                 P, "auto", None, rounds)
            # The mesh-less params wait on the host, so that the runtime's
            # run holds what the mesh-less one held.
            base["params"] = tree_map(lambda x: x.to("cpu"), base["params"])
            release_quiet()
            got = pod_round_run(dev, api, step_cfg, init, {"tokens": toks},
                                P, gossip, mesh, rounds)
            errs = leaf_errors(got["params"], base["params"])
            exact = all(e == 0.0 for e in errs.values())
            w_err = float((got["w"] - base["w"]).abs().max())
            worst = max(errs, key=errs.get)
            print(f"  {gossip} over the {form} pod graph against the "
                  f"mesh-less round: params "
                  + ("bit for bit" if exact else
                     f"max {errs[worst]:.3e} of a leaf's magnitude at "
                     f"{worst}; leaves that differ: "
                     + ", ".join(k for k, e in errs.items() if e))
                  + f"; w max |diff| {w_err:.3e}")
            for r, (a, b) in enumerate(zip(got["metrics"], base["metrics"])):
                print(f"    round {r}: loss {a[0]:.6f} (mesh-less "
                      f"{b[0]:.6f}) acc {a[1]:.6f} ({b[1]:.6f}); wall "
                      f"{got['walls'][r]:.3f} s (mesh-less "
                      f"{base['walls'][r]:.3f} s); launches {got['used'][r]}"
                      f" (mesh-less {base['used'][r]})")
            print(f"    kernels by symbol in a profiled round: "
                  f"{profiled((got['symbols'], got['complete']))} (mesh-less "
                  f"{profiled((base['symbols'], base['complete']))})")
            print(f"    peak device memory {got['peak'] / 1e9:.2f} GB "
                  f"(mesh-less {base['peak'] / 1e9:.2f} GB); card: {card}")
            check(all(e <= 1e-5 for e in errs.values()),
                  f"{gossip}: params {errs}")
            check(w_err <= 1e-6 and abs(float(got["w"].sum()) - n_pods)
                  <= 1e-3, f"{gossip}: w {got['w']} against {base['w']}")
            for (la, aa), (lb, ab) in zip(got["metrics"], base["metrics"]):
                check(math.isfinite(la) and abs(la - lb) <= 1e-5 * abs(lb)
                      and abs(aa - ab) <= 1e-5,
                      f"{gossip}: loss {la} acc {aa} against {lb} {ab}")
            check(got["used"] == base["used"],
                  f"{gossip}: launches {got['used']} against the mesh-less "
                  f"{base['used']}")
            check_same_kernels(gossip, (got["symbols"], got["complete"]),
                               (base["symbols"], base["complete"]))
            per_round = 2 * k_steps * n_pods * cfg.n_layers  # 2 SAM passes
            mix = "gossip_matmul" if form == "dense" else "gossip_gather"
            if dev.type == "cuda":
                check(all(u["flash_attention_backward"] == per_round
                          and u["flash_attention"] == per_round * (
                              2 if cfg.remat else 1) and u[mix] == 1
                          for u in got["used"]),
                      f"{gossip}: launches {got['used']}, expected "
                      f"{per_round} backward calls and one {mix} a round")
            total = got["launches"] if total is None else {
                k: total[k] + got["launches"][k] for k in total}
            del base, got
            release_quiet()
        paths["pod runtime path"] = total
    finally:
        close_clients_world()
    print(f"  phase 21 took {time.perf_counter() - t0:.1f} s")
    release()
    return paths


# -- phase 22: the pod runtime for every other family ---------------------------

# Each family on the one-rank mesh: (arch, layers kept (None: the reduced
# config, f32), rows a pod a step, positions a row).  Full width, bf16,
# cut in depth as phases 15 and 16 cut them; dbrx-132b and
# deepseek-v3-671b at their reduced configs (one full replica's layer and
# its round state do not fit one card: ROADMAP item 13.9).
POD_FAMILIES = (("xlstm-350m", 6, 1, 128),
                ("hymba-1.5b", 2, 1, 1024),
                ("llava-next-mistral-7b", 2, 1, 1024),
                ("hubert-xlarge", 2, 1, 1500),
                ("dbrx-132b", None, 2, 256),
                ("deepseek-v3-671b", None, 2, 256))


def pod_family_run(dev, mesh, arch: str, layers, batch_n: int, seq: int,
                   rounds: int = POD_ROUNDS) -> dict:
    """One family of phase 22: its replicas as DTensors under the pod
    runtime on ``mesh`` against the mesh-less round, from the same state
    (the replicas [x, x / 2] of one draw from seed 0) and batches
    (:func:`round_batches`), 2 pods, K = 2, lr 0.05, alpha 0.9, rho 0.05,
    ``rounds`` rounds under "xla" over the dense ring.  Params and w bit for
    bit, or each leaf within 1e-5 of its magnitude with the leaves that
    differ named; the loss and accuracy; the launches of the flash
    forward, its backward and the dense mix a round, equal (the flash
    kernels launched on the families with GQA attention), and the kernels'
    symbols in a profiled round the same; every leaf of the runtime's
    replicas a DTensor.  Returns the launches of the runtime's rounds."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_map
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model_api

    card = card_line() if dev.type == "cuda" else "no card"
    cfg = (get_config(arch, smoke=True) if layers is None
           else dataclasses.replace(get_config(arch), n_layers=layers))
    api = get_model_api(cfg)
    n_pods, k_steps = 2, 2
    step_cfg = steps.StepConfig(lr=0.05, alpha=0.9, rho=0.05,
                                local_steps=k_steps)
    with torch.no_grad():
        p = api.init(torch.Generator(device=dev).manual_seed(0), dev)
        init = tree_map(lambda x: torch.stack([x, x * 0.5]), p)
        del p
    data = round_batches(cfg, rounds, batch_n, seq, k_steps, device=dev)
    print(f"  {cfg.name}: {cfg.n_layers} layers, "
          f"{api.num_params() / 1e9:.3f} B parameters a replica in "
          f"{str(cfg.dtype)[6:]}; {batch_n} x {seq} positions a pod a step; "
          "a step's batch: " + ", ".join(
              f"{k} {tuple(x.shape[3:])}" for k, x in data.items()))
    P = steps.pod_mixing_matrix(n_pods, dev)
    base = pod_round_run(dev, api, step_cfg, init, data, P, "auto", None,
                         rounds)
    base["params"] = tree_map(lambda x: x.to("cpu"), base["params"])
    release_quiet()
    got = pod_round_run(dev, api, step_cfg, init, data, P, "xla", mesh,
                        rounds)
    del init
    errs = leaf_errors(got["params"], base["params"])
    exact = all(e == 0.0 for e in errs.values())
    w_err = float((got["w"] - base["w"]).abs().max())
    worst = max(errs, key=errs.get)
    print("    params " + ("bit for bit" if exact else
                           f"max {errs[worst]:.3e} of a leaf's magnitude at "
                           f"{worst}; leaves that differ: "
                           + ", ".join(k for k, e in errs.items() if e))
          + f"; w max |diff| {w_err:.3e}")
    for r, (a, b) in enumerate(zip(got["metrics"], base["metrics"])):
        print(f"    round {r}: loss {a[0]:.6f} (mesh-less {b[0]:.6f}) acc "
              f"{a[1]:.6f} ({b[1]:.6f}); wall {got['walls'][r]:.3f} s "
              f"(mesh-less {base['walls'][r]:.3f} s); launches "
              f"{got['used'][r]} (mesh-less {base['used'][r]})")
    print(f"    kernels by symbol in a profiled round: "
          f"{profiled((got['symbols'], got['complete']))} (mesh-less "
          f"{profiled((base['symbols'], base['complete']))})")
    print(f"    peak device memory {got['peak'] / 1e9:.2f} GB (mesh-less "
          f"{base['peak'] / 1e9:.2f} GB); card: {card}")
    check(all(e <= 1e-5 for e in errs.values()), f"{arch}: params {errs}")
    check(w_err <= 1e-6 and abs(float(got["w"].sum()) - n_pods) <= 1e-3,
          f"{arch}: w {got['w']} against {base['w']}")
    for (la, aa), (lb, ab) in zip(got["metrics"], base["metrics"]):
        check(math.isfinite(la) and abs(la - lb) <= 1e-5 * abs(lb)
              and abs(aa - ab) <= 1e-5,
              f"{arch}: loss {la} acc {aa} against {lb} {ab}")
    check(got["used"] == base["used"],
          f"{arch}: launches {got['used']} against the mesh-less "
          f"{base['used']}")
    check_same_kernels(arch, (got["symbols"], got["complete"]),
                       (base["symbols"], base["complete"]))
    if dev.type == "cuda":
        per_round = 2 * k_steps * n_pods * flash_layers(cfg)  # 2 SAM passes
        check(all(u["gossip_matmul"] == 1
                  and u["flash_attention_backward"] == per_round
                  and u["flash_attention"] == per_round * (
                      2 if cfg.remat else 1) for u in got["used"]),
              f"{arch}: launches {got['used']}, expected {per_round} flash "
              "backward calls and one dense mix a round")
    return got["launches"]


def pod_families_phase(dev, head=print, families=POD_FAMILIES,
                       rounds: int = POD_ROUNDS) -> dict:
    """Phase 22 whole (``head`` prints each step's heading): the pod
    runtime on a one-rank NCCL world's ``(1, 1, 1)`` mesh (gloo on the
    CPU) for xlstm-350m, hymba-1.5b, llava-next-mistral-7b and
    hubert-xlarge at full width cut in depth, and dbrx-132b and
    deepseek-v3-671b at their reduced configs (:data:`POD_FAMILIES`), each
    through :func:`pod_family_run`.  Closes its process group.  Returns
    the launches of each family's runtime rounds.  ``python3
    repeat_phase.py --repeat 1 pod_families_phase`` runs it alone."""
    from repro_torch.launch.mesh import close_clients_world, init_world

    card = card_line() if dev.type == "cuda" else "no card"
    t0 = time.perf_counter()
    mesh = init_world(0, 1, free_port(), dev, *POD_MESH)
    paths = {}
    try:
        for arch, layers, batch_n, seq in families:
            width = ("at its reduced config (one full replica's layer and "
                     "its round state do not fit one card)" if layers is None
                     else f"at full width cut to {layers} layers")
            head(f"[22] the pod runtime on a one-rank NCCL world: {arch} "
                 f"{width}, 2 pods on a {POD_MESH[0]} {POD_MESH[1]} mesh, "
                 f"K = 2, {batch_n} x {seq} positions, {rounds} rounds under "
                 f"xla, against the mesh-less round; card: {card}")
            t = time.perf_counter()
            paths[f"{arch} pod runtime path"] = pod_family_run(
                dev, mesh, arch, layers, batch_n, seq, rounds)
            release_quiet()
            print(f"  {arch} took {time.perf_counter() - t:.1f} s")
    finally:
        close_clients_world()
    print(f"  phase 22 took {time.perf_counter() - t0:.1f} s")
    release()
    return paths


# -- phase 23: serving on the pod runtime's mesh -------------------------------

# Each decoding family on the one-rank mesh: (arch, layers kept (None: the
# reduced config, f32), requests, prompt positions).  glm4-9b at full width
# cut to TRAIN_LAYERS with 8 requests of 2048 tokens, the others at phase
# 22's configs.
PLACED_SERVE = (("glm4-9b", TRAIN_LAYERS, 8, 2048),) + tuple(
    f for f in POD_FAMILIES if f[0] != "hubert-xlarge")
PLACED_NEW = 16  # new tokens a request: one from the prefill, 15 steps


def placed_serve_run(dev, mesh, arch: str, layers, batch_n: int, seq: int,
                     new: int = PLACED_NEW) -> dict:
    """One family of phase 23: ``launch.serve.generate`` on the replica
    placed over the one-rank mesh's ``(data, model)`` submesh
    (``launch.sharding.place_params``, the requests by
    ``launch.steps.place_batch``, under ``sharding.use_mesh``: the prefill
    builds the cache as DTensors, each step reads and writes the rank's
    blocks) against the mesh-less ``generate``, from the same params (seed
    0) and prompts (``serve.prompts``, seed 0).  Equal tokens, and the
    logits bit for bit; the launches of the flash forward over the whole
    generate (every counter) equal, and the kernels by symbol in one more
    profiled prefill (of a family with flash layers; up to
    :data:`PROFILE_TRIES` until a profile holds every launch) held by
    :func:`check_same_kernels`.  Prints both sides'
    prefill seconds, decode ms a step and peak memory.  Returns the
    launches of the placed generate."""
    import contextlib
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flat import tree_flatten
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.steps import place_batch
    from repro_torch.models.registry import get_model_api
    from torch.distributed.tensor.experimental import implicit_replication

    card = card_line() if dev.type == "cuda" else "no card"
    cfg = (get_config(arch, smoke=True) if layers is None
           else dataclasses.replace(get_config(arch), n_layers=layers))
    api = get_model_api(cfg)
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = serve.prompts(cfg, batch_n, seq, 0, dev)
    n_prefix = serve.N_IMAGE if cfg.task == "vlm" else 0
    print(f"  {cfg.name}: {cfg.n_layers} layers, "
          f"{api.num_params() / 1e9:.3f} B parameters in "
          f"{str(cfg.dtype)[6:]}; {batch_n} requests of {seq} tokens"
          + (f" after {n_prefix} image embeddings" if n_prefix else "")
          + f", {new} new tokens each")
    def one(p, b, on_mesh):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with on_mesh():
            rec = serve.generate(api, p, b, new)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        del rec["cache"]  # not held through the other side's run
        if not flash_layers(cfg):  # no kernel to name (xlstm, MLA)
            return rec, launches, peak, ({}, True)
        placed = (implicit_replication if shlib.is_dtensor(b["tokens"])
                  else contextlib.nullcontext)
        for _ in range(PROFILE_TRIES):  # until a profile holds every launch
            before = read_counts()["flash_attention"]
            with on_mesh(), placed(), torch.no_grad(), \
                    device_profile(dev) as prof:
                api.prefill(p, b, n_prefix + seq + new)
            symbols = kernel_symbols(prof)
            del prof
            full = (sum(symbols.values())
                    == read_counts()["flash_attention"] - before)
            if full:
                break
        return rec, launches, peak, (symbols, full)

    base, base_n, base_peak, base_sym = one(params, batch,
                                            contextlib.nullcontext)
    release_quiet()
    placed = shlib.place_params(params, api.param_defs(), mesh, cfg.fsdp,
                                model_axes=shlib.model_axes_for(cfg))
    del params
    check(all(shlib.is_dtensor(x) for x in tree_flatten(placed)[1]),
          f"{arch}: the placement left plain tensors")
    pbatch = place_batch(batch, mesh, 0)
    got, got_n, got_peak, got_sym = one(
        placed, pbatch, lambda: shlib.use_mesh(mesh, fsdp=cfg.fsdp))
    same_logits = torch.equal(got["logits"], base["logits"])
    err = (float((got["logits"].float() - base["logits"].float()).abs().max())
           / float(base["logits"].float().abs().max()))
    steps = max(base["steps"], 1)
    print(f"    tokens {'equal' if torch.equal(got['tokens'], base['tokens']) else 'DIFFER'}; "
          f"logits {'bit for bit' if same_logits else f'max {err:.3e} of their magnitude'}")
    print(f"    prefill {got['prefill_s']:.3f} s (mesh-less "
          f"{base['prefill_s']:.3f} s); decode "
          f"{1e3 * got['decode_s'] / steps:.2f} ms a step (mesh-less "
          f"{1e3 * base['decode_s'] / steps:.2f} ms: DTensor's host "
          f"dispatch); peak device memory {got_peak / 1e9:.2f} GB (mesh-less "
          f"{base_peak / 1e9:.2f} GB); card: {card}")
    print(f"    flash launches {got_n['flash_attention']} (mesh-less "
          f"{base_n['flash_attention']}); kernels by symbol in a prefill: "
          f"{profiled(got_sym)} (mesh-less {profiled(base_sym)})")
    check(got["finite"] and base["finite"], f"{arch}: logits not finite")
    check(torch.equal(got["tokens"], base["tokens"]),
          f"{arch}: tokens {got['tokens']} against {base['tokens']}")
    check(same_logits, f"{arch}: logits differ, {err:.3e} of their "
          "magnitude")
    check(got_n == base_n,
          f"{arch}: launches {got_n} against the mesh-less {base_n}")
    check_same_kernels(arch, got_sym, base_sym)
    if dev.type == "cuda":
        check(got_n["flash_attention"] == flash_layers(cfg),
              f"{arch}: {got_n['flash_attention']} flash launches, expected "
              f"{flash_layers(cfg)} in the prefill")
    del got, base, placed, pbatch
    return got_n


def placed_serving_phase(dev, head=print, families=PLACED_SERVE,
                         new: int = PLACED_NEW) -> dict:
    """Phase 23 whole (``head`` prints each step's heading): serving on the
    pod runtime's mesh, a one-rank NCCL world's ``(1, 1, 1)`` mesh (gloo on
    the CPU), for every decoding family of :data:`PLACED_SERVE`, each
    through :func:`placed_serve_run`.  Closes its process group.  Returns
    the launches of each family's placed generate.  ``python3
    repeat_phase.py --repeat 1 placed_serving_phase`` runs it alone."""
    from repro_torch.launch.mesh import close_clients_world, init_world

    card = card_line() if dev.type == "cuda" else "no card"
    t0 = time.perf_counter()
    mesh = init_world(0, 1, free_port(), dev, *POD_MESH)
    paths = {}
    try:
        for arch, layers, batch_n, seq in families:
            width = ("at its reduced config" if layers is None
                     else f"at full width cut to {layers} layers")
            head(f"[23] placed serving on a one-rank NCCL world: {arch} "
                 f"{width}, {batch_n} x {seq} tokens, {new} new, the cache "
                 f"placed on a {POD_MESH[0]} {POD_MESH[1]} mesh, against the "
                 f"mesh-less generate; card: {card}")
            t = time.perf_counter()
            paths[f"{arch} placed serving path"] = placed_serve_run(
                dev, mesh, arch, layers, batch_n, seq, new)
            release_quiet()
            print(f"  {arch} took {time.perf_counter() - t:.1f} s")
    finally:
        close_clients_world()
    print(f"  phase 23 took {time.perf_counter() - t0:.1f} s")
    release()
    return paths


def release_quiet() -> None:
    """:func:`release` without its line."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


REPLACES = {
    "fused_update_bank": ("src/repro_torch/kernels/csrc/fused_update.cu",
                          "src/repro/kernels/fused_update.py:100"),
    "gossip_matmul": ("src/repro_torch/kernels/csrc/gossip_matmul.cu",
                      "src/repro/kernels/gossip_matmul.py:27"),
    "gossip_gather": ("src/repro_torch/kernels/csrc/gossip_gather.cu",
                      "src/repro/kernels/gossip_gather.py:58"),
    "fused_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "src/repro/kernels/fused_update.py:33"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:70"),
    # The same kernel's hd 80 instantiations (hubert-xlarge), timed at
    # hubert's shape; its launches are the ones at hd 80.
    "flash_attention_hd80": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70"),
    # The gradient of that kernel's function; the TPU package has no Pallas
    # backward (its training differentiates the plain attention).
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:70"),
    # The backward's hd 80 instantiations (hubert-xlarge), timed at hubert's
    # training shape; its launches are the calls at hd 80.
    "flash_attention_backward_hd80": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:70"),
    # Its hd 256 tensor-core passes (gemma3-12b), timed at gemma3-12b's
    # global layer; its launches are the calls at hd 256.
    "flash_attention_backward_hd256": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:70"),
}


def release() -> None:
    """Free what the phase before left on the card: its cyclic garbage
    first (trainers and runners hold reference cycles, so their tensors
    outlive the phase until the collector runs, whenever that is), then
    the allocator's cached blocks; print what stays live."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (live device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB after the phase)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    starts = {"[1]": 0.0}  # each phase's first heading, seconds from start

    def head(line: str) -> None:
        at = time.perf_counter() - t_start
        starts.setdefault(line.split(" ", 1)[0], at)
        print(f"{line} (at {at:.1f} s)")

    card = card_line()
    print(f"[1] card: {card}")
    starts["[2]"] = time.perf_counter() - t_start
    t = time.perf_counter()
    build.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t:.1f} s; "
          "the flash kernels:")
    flash_build_evidence()
    print("[2] the gossip mixes' kernels:")
    mix_build_evidence()
    paths = {}
    head(f"[3] kernels at n={N_CLIENTS} D={CIFAR_CNN_DIM}")
    rows = kernel_phase(dev, N_CLIENTS, CIFAR_CNN_DIM)
    head(f"[3] kernels at the delta bank's n={N_CLIENTS} "
         f"d_delta={DELTA_DIM}, bf16")
    delta_kernel_phase(dev)
    head("[4] card round against CPU round, same draws")
    small_parity(dev)
    scenario_parity(dev)
    # Made once on the host for phases 5, 8 and 9; each copies it to the
    # card, so phase 7's peak memory holds none of it.
    data = cifar_data(torch.device("cpu"))

    def on_card():
        return tuple({k: v.to(dev) for k, v in part.items()} for part in data)

    head("[5] main path: DFedSGPSM, cifar_cnn, 100 clients, kout k_out=10")
    paths["FL path"] = main_path(dev, data=on_card())
    head("[6] crossover: dense against sparse mix")
    crossover(dev, CIFAR_CNN_DIM)
    head("[7] serving: reduced gemma3-12b, card against CPU, f32")
    serving_parity(dev, "gemma3-12b")
    head("[7] serving: gemma3-12b at full width, bf16, 4 x 2048 tokens")
    paths["serving path"] = serving(dev)
    release()
    head("[8] scenario path: cifar_cnn, 100 clients, kout k_out=10, "
         "links, churn, compressors, proximal solver, delta bank")
    paths["scenario path"], kept = scenario_path(dev, on_card())
    head("[9] checkpoints at full width: scenario A and the bf16 delta "
         "bank")
    paths["checkpoint phase"] = checkpoint_phase(dev, on_card(), kept)
    del kept
    release()
    head(f"[10] paged store: mnist_2nn, n={PAGED_N}, "
         f"k_active={PAGED_K_ACTIVE}, kout k_out={PAGED_K_OUT}")
    paths["paged path"] = paged_phase(dev)
    release()
    head("[11] personalized serving: glm4-9b at full width, bf16, "
         "2 clients x 2048 tokens")
    paths["personalized serving path"] = personalized(dev)
    release()
    head(f"[12] training: the flash backward kernel; card: {card}")
    backward_build_evidence()
    (rows["flash_attention_backward"], rows["flash_attention_backward_hd80"],
     rows["flash_attention_backward_hd256"]) = flash_backward_phase(dev)
    release()
    head("[12] training: reduced glm4-9b, 2 pods, card against CPU, f32")
    train_parity(dev)
    head(f"[12] training: glm4-9b at full width cut to {TRAIN_LAYERS} "
         "layers, 2 pods, K = 2, 1 x 4096 tokens, 3 rounds")
    paths["training path"] = training(dev)
    release()
    for arch in MOE_SERVE:
        head(f"[13] serving the MoE family: reduced {arch}, card against "
             "CPU, f32")
        serving_parity(dev, arch)
    for arch, (layers, batch_n) in MOE_SERVE.items():
        head(f"[13] serving the MoE family: {arch} at full width, bf16, "
             f"{batch_n} x {MOE_PROMPT} tokens; card: {card}")
        paths[f"{arch} serving path"] = moe_serving(dev, arch, layers,
                                                    batch_n)
        release()
    head(f"[14] the vlm and masked_lm tasks: the flash kernel at hd 80; "
         f"card: {card}")
    rows["flash_attention_hd80"] = flash_hd80_phase(dev)
    release()
    head("[14] reduced llava-next-mistral-7b, card against CPU, f32")
    serving_parity(dev, "llava-next-mistral-7b")
    head("[14] reduced hubert-xlarge at hd 80, card against CPU, f32")
    encoder_parity(dev)
    head(f"[14] llava-next-mistral-7b at full width, bf16, {LLAVA_REQUESTS} x "
         f"{LLAVA_SEQ} positions (image + text); card: {card}")
    paths["llava-next-mistral-7b serving path"] = vlm_serving(dev)
    release()
    head(f"[14] hubert-xlarge at full width, bf16, {HUBERT_CLIPS} x "
         f"{HUBERT_FRAMES} frames; card: {card}")
    paths["hubert-xlarge encoder path"] = encoder_path(dev)
    release()
    paths.update(blocks_phase(dev, head))
    paths.update(tasks_phase(dev, head))
    paths.update(lanes_phase(dev, head))
    paths.update(sharding_phase(dev, on_card(), head))
    paths.update(dryrun_phase(dev, head))
    paths.update(gemma_phase(dev, head))
    paths.update(pod_runtime_phase(dev, head))
    paths.update(pod_families_phase(dev, head))
    paths.update(placed_serving_phase(dev, head))
    # Each path's counts run from 0 just before it to just after it.
    names = counters()
    launches = {k: sum(p[k] for p in paths.values()) for k in names}
    print("launches: " + "; ".join(f"{k} {v}" for k, v in paths.items()))
    total = time.perf_counter() - t_start
    ends = list(starts.values())[1:] + [total]
    print("phase times: " + ", ".join(
        f"{k} {end - at:.1f} s" for (k, at), end in zip(starts.items(), ends)))
    print(f"total {total:.1f} s")
    print(card)
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
