"""The pods-as-clients round of the ``masked_lm`` and ``vlm`` tasks, the
port against the JAX reference on the CPU: ``repro_torch.launch.steps.
make_round_step`` against ``repro.launch.steps.make_round_step`` (under
``jax.jit``) on the same ``configs.registry.make_batch`` draws, from the
same initial state (the reference's ``init`` carried over by
``repro_torch.interop``), 2 pods, K = 2, lr 0.05, alpha 0.9, rho 0.05, the
dense ``P_pod``, 2 rounds, each restarted from the reference's state
(``_torch_blocks.pod_round_parity``).

- masked_lm: hubert-xlarge at ``reduced`` size widened to d_model 320,
  which keeps 4 heads of hd 80 (on 2 kv heads), as on the card; its
  attention core is ``ops.flash_attention`` at hd 80, non-causal (on the
  CPU the kernel's plain version, under autograd its plain backward).
- vlm: llava-next-mistral-7b at ``reduced`` size: 16 image embeddings
  through the projector before the text, out of the loss.

The batches are the port's ``configs.registry.make_round_batches``: one
``make_batch`` draw of rounds x 2 pods x K x B rows, cut to (rounds, 2, K,
B, ...), as ``chip_smoke.round_batches`` draws them for the card; both
packages' ``make_batch`` give the same arrays, so the reference's cut of
its own draw is the same batches.

Tolerance: both sides compute in f32 with their sums in their own orders:
every params and momentum leaf to 1e-5 of its largest magnitude, or twice
what the reference's own leaf moves under f32-scale noise where that is
larger (``_torch_blocks.drifts``); ``w`` to 1e-6; the loss to 1e-5
relative; the accuracy to one position a step (a masked frame, a text
token).
"""
import dataclasses

import numpy as np
import pytest
from _torch_blocks import (  # noqa: F401  (one_thread is an autouse fixture)
    apis,
    one_thread,
    pod_round_parity,
)

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry

ROUNDS, PODS, K = 2, 2, 2
# arch -> (reduced-config overrides, rows a pod a step, positions a row)
CASES = {"hubert-xlarge": (dict(d_model=320), 2, 24),
         "llava-next-mistral-7b": ({}, 2, 40)}


def _configs(arch: str):
    over = CASES[arch][0]
    return (dataclasses.replace(ref_base.reduced(ref_registry.get_config(arch)),
                                **over),
            dataclasses.replace(base.reduced(registry.get_config(arch)),
                                **over))


def _batches(cfg, b: int, s: int, seed: int = 3) -> dict:
    cut = registry.make_round_batches(cfg, ROUNDS, PODS, K, b, s, seed=seed)
    return {k: v.numpy() for k, v in cut.items()}


@pytest.mark.parametrize("arch", list(CASES))
def test_both_packages_draw_the_same_task_batches(arch):
    """The port's round batches are the reference's ``make_batch`` draw of
    all their rows, cut to (rounds, 2, K, B, ...)."""
    ref_cfg, cfg = _configs(arch)
    _, b, s = CASES[arch]
    want = ref_registry.make_batch(ref_cfg, ROUNDS * PODS * K * b, s, seed=3)
    got = _batches(cfg, b, s)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].reshape(-1, *got[k].shape[4:]), np.asarray(want[k]))


@pytest.mark.parametrize("arch", list(CASES))
def test_step_positions_counts_what_a_step_scores(arch):
    """``step_positions``: the fewest masked frames of a masked_lm step,
    else a step's text positions but the first; never 0 here."""
    _, cfg = _configs(arch)
    _, b, s = CASES[arch]
    cut = registry.make_round_batches(cfg, ROUNDS, PODS, K, b, s, seed=3)
    if cfg.task == "masked_lm":
        want = min(int(cut["mask"][r, p, k].sum()) for r in range(ROUNDS)
                   for p in range(PODS) for k in range(K))
    else:
        want = b * (cut["tokens"].shape[-1] - 1)
        assert cut["tokens"].shape[-1] < s  # the image prefix is not text
    assert registry.step_positions(cut) == want > 0


@pytest.mark.parametrize("arch", list(CASES))
def test_pod_round_matches_the_reference(arch):
    """Two rounds, each restarted from the reference's state; the head dim
    is 80 for hubert-xlarge and 64 for llava-next-mistral-7b."""
    ref_cfg, cfg = _configs(arch)
    assert cfg.resolved_head_dim == (80 if arch == "hubert-xlarge" else 64)
    ref_api, api, ref_params, _ = apis(ref_cfg, cfg)
    _, b, s = CASES[arch]
    batches = _batches(cfg, b, s)
    losses = pod_round_parity(ref_api, api, ref_params, batches, 1e-5)
    assert len(losses) == ROUNDS and all(np.isfinite(losses))
