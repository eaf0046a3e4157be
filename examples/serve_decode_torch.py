"""Serve a reduced model of the port's zoo with batched requests: prefill
the prompt batch (after its image prefix, for the vlm) into the KV cache,
then decode greedily.  The twin of ``examples/serve_decode.py``, over the
decoders the port holds (hubert-xlarge is an encoder: no decode path).

The cache holds the image prefix, the prompt and the new tokens, and step
i decodes at prefix + prompt + i (``repro_torch.launch.serve.generate``);
the reference example sizes its cache without the prefix (ROADMAP §3).

  python examples/serve_decode_torch.py --arch llava-next-mistral-7b           # card
  python examples/serve_decode_torch.py --arch llava-next-mistral-7b --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.registry import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import get_model_api  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b",
                    choices=[a for a in PORTED_ARCH_IDS if a != "hubert-xlarge"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=True)  # the reduced variant
    api = get_model_api(cfg)
    with torch.no_grad():
        params = api.init(torch.Generator(device=device).manual_seed(0), device)
    print(f"{cfg.name}: reduced variant, {api.num_params() / 1e6:.2f}M params")
    batch = serve.prompts(cfg, args.batch, args.prompt_len, 0, device)
    rec = serve.generate(api, params, batch, args.new_tokens)
    steps = rec["steps"]
    print(f"decoded {steps} steps x {args.batch} seqs after a prefix of "
          f"{rec['n_prefix']} image embeddings in {rec['decode_s']:.2f}s "
          f"({1e3 * rec['decode_s'] / max(steps, 1):.1f} ms/step); cache "
          f"{rec['n_prefix'] + args.prompt_len + args.new_tokens} positions")
    return rec


if __name__ == "__main__":
    main()
