"""Pods-as-clients DFL pretraining with the PyTorch port (the paper's
technique at datacenter scale): every "pod" holds a full model replica;
pods run K local SAM-momentum steps on their own token stream and exchange
parameters by directed push-sum gossip — no cross-pod all-reduce.  The twin
of ``examples/pod_gossip_pretrain.py``.

This is ``repro_torch.launch.train`` with the example's defaults: the
reduced (``--smoke``) glm4-9b, 2 pods stacked on one device, K = 2, a
per-pod batch of 8 sequences of 64 tokens.  The reference example's
default architecture, xlstm-350m, runs with ``--arch xlstm-350m`` (it is
also the launcher's own default).  Any of the launcher's flags may follow
and override these.

  python examples/pod_gossip_pretrain_torch.py --rounds 10              # card
  python examples/pod_gossip_pretrain_torch.py --rounds 10 --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train  # noqa: E402

DEFAULTS = ["--arch", "glm4-9b", "--smoke", "--rounds", "10",
            "--local-steps", "2", "--batch", "8", "--seq", "64"]


def main(argv=None):
    rec = train.main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))
    print("done — consensus mass conserved:", rec["history"][-1]["w_mass"])
    return rec


if __name__ == "__main__":
    main()
